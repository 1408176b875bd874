"""LM model zoo of the port.  ``get_model(cfg)`` returns the module that
implements the family: init_params / forward / loss / init_cache / prefill /
decode_step.  The audio family is ``whisper``, the vlm family ``vlm``."""
import importlib

from repro_torch.models.lmconfig import LMConfig  # noqa: F401

_MODULES = {"dense": "dense", "moe": "moe", "ssm": "ssm", "hybrid": "hybrid",
            "audio": "whisper", "vlm": "vlm"}


def get_model(cfg: LMConfig):
    if cfg.family not in _MODULES:
        raise ValueError(f"unknown LM family {cfg.family!r} ({cfg.arch_id})")
    return importlib.import_module(
        f"repro_torch.models.{_MODULES[cfg.family]}")
