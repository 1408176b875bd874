"""qwen1.5-110b [hf:Qwen family]: dense with QKV bias.
80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064."""
from repro_torch.models.lmconfig import LMConfig

ARCH_ID = "qwen1.5-110b"
CONFIG = LMConfig(
    arch_id=ARCH_ID, family="dense",
    n_layer=80, d_model=8192, n_head=64, n_kv_head=8, d_ff=49152,
    vocab=152064, qkv_bias=True, fsdp=True,
)
