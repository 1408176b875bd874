"""LM model zoo of the port.  ``get_model(cfg)`` returns the module that
implements the family's serving API: init_params / forward / init_cache /
prefill / decode_step.  The dense, moe, ssm and hybrid families are
ported; audio (whisper) and vlm (internvl2) are not."""
from repro_torch.models.lmconfig import LMConfig  # noqa: F401


def get_model(cfg: LMConfig):
    if cfg.family in ("dense", "moe", "ssm", "hybrid"):
        import importlib
        return importlib.import_module(f"repro_torch.models.{cfg.family}")
    raise NotImplementedError(
        f"the {cfg.family!r} family ({cfg.arch_id}) is not ported yet: "
        "ROADMAP.md queue 1, item 3 (LM zoo: whisper and internvl2 serving)")
