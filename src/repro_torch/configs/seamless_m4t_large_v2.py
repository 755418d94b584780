"""seamless-m4t-large-v2 [audio] — enc-dec 24L+24L d=1024 16H ff=8192
vocab=256206. Multimodal; the audio frontend is a STUB (input_specs provides
precomputed frame embeddings). [arXiv:2308.11596; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    rope="full",
    input_kind="frames",
)
