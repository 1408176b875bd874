"""LM model zoo of the port.  ``get_model(cfg)`` returns the module that
implements the family's serving API: init_params / forward / init_cache /
prefill / decode_step.  Only the dense family is ported."""
from repro_torch.models.lmconfig import LMConfig  # noqa: F401


def get_model(cfg: LMConfig):
    if cfg.family == "dense":
        from repro_torch.models import dense
        return dense
    raise NotImplementedError(
        f"the {cfg.family!r} family ({cfg.arch_id}) is not ported yet: "
        "ROADMAP.md queue 1, item 5 (LM zoo)")
