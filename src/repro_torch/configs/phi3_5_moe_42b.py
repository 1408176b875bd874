"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct].
32L d_model=4096 32H (GQA kv=8) d_ff=6400(per-expert) vocab=32064, 16 experts top-2."""
from repro_torch.models.lmconfig import LMConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"
CONFIG = LMConfig(
    arch_id=ARCH_ID, family="moe",
    n_layer=32, d_model=4096, n_head=32, n_kv_head=8, vocab=32064,
    n_experts=16, top_k=2, moe_d_ff=6400, n_shared_experts=0,
    expert_pad_to=16, fsdp=True,
)
