"""deepseek-coder-33b [arXiv:2401.14196]: llama-arch dense.
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256."""
from repro_torch.models.lmconfig import LMConfig

ARCH_ID = "deepseek-coder-33b"
CONFIG = LMConfig(
    arch_id=ARCH_ID, family="dense",
    n_layer=62, d_model=7168, n_head=56, n_kv_head=8, d_ff=19200,
    vocab=32256, fsdp=True,
)
