"""The CrossCLR intra-modality loss of ``[B, D]`` fp32 embeddings: the
similarity products ``ṽ t̃ᵀ`` (``2·B²·D``) and the symmetric ``ṽ ṽᵀ`` and
``t̃ t̃ᵀ`` (half each: ``B²·D``), so ``4·B²·D`` forward.  Backward, with no
recompute counted: ``dṽ = dS_vt t̃ + (dS_vv + dS_vvᵀ) ṽ`` and
``dt̃ = dS_vtᵀ ṽ + (dS_tt + dS_ttᵀ) t̃``, four products: ``8·B²·D``.
Bytes: forward reads both embeddings (``2·B·D·4``) and writes a scalar;
backward reads them and writes their gradients (``4·B·D·4``)."""


def forward_flops(b: int, d: int) -> float:
    return 4.0 * b * b * d


def backward_flops(b: int, d: int) -> float:
    return 8.0 * b * b * d


def forward_bytes(b: int, d: int) -> float:
    return 8.0 * b * d


def backward_bytes(b: int, d: int) -> float:
    return 16.0 * b * d
