"""Assigned input shapes and per-(arch x shape) applicability + input specs.

Every spec is a tensor on the ``meta`` device (shape and dtype, no memory:
the counterpart of the reference's ``ShapeDtypeStruct``). ``decode_*`` /
``long_*`` describe the serve step (one new token against a ``seq_len`` KV
cache); ``train_4k`` describes the train step; ``prefill_32k`` describes the
prefill function.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import as_dtype


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence handling: run only for SSM / hybrid
# archs.
LONG_OK_FAMILIES = ("ssm", "hybrid")
ENC_DEC_FRAC = 0.25  # decoder length = seq/4 for enc-dec (ASR-ish ratio)


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return False, "full-attention arch at 500k context (per assignment rule)"
    return True, ""


def dec_len(shape: ShapeSpec) -> int:
    """The encoder-decoder family's decoder length at ``shape``."""
    return max(16, int(shape.seq_len * ENC_DEC_FRAC))


def token_specs(cfg: ArchConfig, shape: ShapeSpec, device="meta") -> dict:
    """The data batch of this cell, as empty tensors on ``device``."""
    b, s = shape.global_batch, shape.seq_len

    def i32(*dims):
        return torch.empty(dims, dtype=torch.int32, device=device)

    if cfg.family == "encdec":
        dec = dec_len(shape)
        frames = torch.empty((b, s, cfg.d_model), dtype=as_dtype(cfg.dtype), device=device)
        if shape.kind == "train":
            return {"frames": frames, "tokens": i32(b, dec), "labels": i32(b, dec)}
        if shape.kind == "prefill":
            return {"frames": frames, "tokens": i32(b, dec)}
        return {"token": i32(b)}
    if shape.kind == "train":
        return {"tokens": i32(b, s), "labels": i32(b, s)}
    if shape.kind == "prefill":
        return {"tokens": i32(b, s)}
    return {"token": i32(b)}


def token_logical_axes(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Logical axes matching :func:`token_specs`."""
    if cfg.family == "encdec":
        if shape.kind == "train":
            return {
                "frames": ("batch", "seq", None),
                "tokens": ("batch", "seq"),
                "labels": ("batch", "seq"),
            }
        if shape.kind == "prefill":
            return {"frames": ("batch", "seq", None), "tokens": ("batch", "seq")}
        return {"token": ("batch",)}
    if shape.kind == "train":
        return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if shape.kind == "prefill":
        return {"tokens": ("batch", "seq")}
    return {"token": ("batch",)}
