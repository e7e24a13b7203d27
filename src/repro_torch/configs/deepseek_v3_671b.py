"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048 (expert width)
vocab=129280.  MLA latent attention, 1 shared + 256 routed experts top-8,
MTP [arXiv:2412.19437].  long_500k runs with FULL attention: the MLA latent
cache is (512+64) floats/token, so a 500k-token cache is ~600 MB — MLA is
precisely the long-context enabler here (DESIGN.md §4)."""
from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        d_ff=2048,
        vocab_size=129280,
        source="[arXiv:2412.19437]",
        use_mla=True,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        use_moe=True,
        first_k_dense=3,
        moe=MoEConfig(num_experts=256, experts_per_token=8,
                      num_shared_experts=1, d_ff_expert=2048,
                      capacity_factor=1.25),
        mtp_depth=1,
        mtp_loss_weight=0.3,
        long_context_window=0,        # MLA latent cache: full attention is cheap
    )
