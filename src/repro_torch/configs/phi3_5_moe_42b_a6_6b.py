"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.config import MoEConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        arch_type="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        source="[hf:microsoft/Phi-3.5-MoE-instruct]",
        use_moe=True,
        moe=MoEConfig(num_experts=16, experts_per_token=2,
                      num_shared_experts=0, d_ff_expert=6400,
                      capacity_factor=1.25),
        long_context_window=8192,
    )
