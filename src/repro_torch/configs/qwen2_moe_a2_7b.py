"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B].
24L d_model=2048 16H (GQA kv=16) d_ff=1408(per-expert) vocab=151936,
60 routed experts top-4 + 4 shared experts (always active)."""
from repro_torch.models.lmconfig import LMConfig

ARCH_ID = "qwen2-moe-a2.7b"
CONFIG = LMConfig(
    arch_id=ARCH_ID, family="moe",
    n_layer=24, d_model=2048, n_head=16, n_kv_head=16, vocab=151936,
    n_experts=60, top_k=4, moe_d_ff=1408, n_shared_experts=4,
    shared_d_ff=5632, expert_pad_to=64, qkv_bias=True, fsdp=True,
)
