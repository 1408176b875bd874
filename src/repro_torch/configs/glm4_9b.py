"""glm4-9b [hf:THUDM/glm-4-9b]: dense, RoPE, GQA kv=2.
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552."""
from repro_torch.models.lmconfig import LMConfig

ARCH_ID = "glm4-9b"
CONFIG = LMConfig(
    arch_id=ARCH_ID, family="dense",
    n_layer=40, d_model=4096, n_head=32, n_kv_head=2, d_ff=13696,
    vocab=151552, qkv_bias=True, fsdp=True,
)
