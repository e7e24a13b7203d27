"""memori-embedder — the in-framework replacement for the paper's Gemma-300
embedding model: a small bidirectional transformer encoder, mean-pooled to a
256-d embedding, used by the Advanced Augmentation pipeline to embed semantic
triples (DESIGN.md §3 adaptation note 2)."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="memori-embedder",
        arch_type="dense",
        num_layers=4,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=1024,
        vocab_size=32768,
        source="[this paper: Gemma-300 replacement]",
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
    )
