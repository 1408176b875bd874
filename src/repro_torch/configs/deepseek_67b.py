"""deepseek-67b [arXiv:2401.02954]: llama-arch dense.
95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400."""
from repro_torch.models.lmconfig import LMConfig

ARCH_ID = "deepseek-67b"
CONFIG = LMConfig(
    arch_id=ARCH_ID, family="dense",
    n_layer=95, d_model=8192, n_head=64, n_kv_head=8, d_ff=22016,
    vocab=102400, fsdp=True,
)
