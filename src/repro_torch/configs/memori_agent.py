"""memori-agent — the paper's own serving model for the end-to-end examples:
a small dense LM (~100M class) served behind the MemoriClient SDK and used
by the train_100m example.  (The paper is LLM-agnostic; any zoo config can
take this role — this one is small enough to train/serve on the CI box.)"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="memori-agent",
        arch_type="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        d_ff=2048,
        vocab_size=32768,
        source="[this paper: Memori serving default]",
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
        long_context_window=4096,
    )
