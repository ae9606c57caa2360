"""Exported serving artifacts (``torch.export``).

Counterpart of ``crossclr_tpu/aot.py``.  :func:`export_search` captures a
:class:`~crossclr_tpu_torch.serve.RetrievalService`'s query → top-k path,
the query tower and its parameters included, as a ``torch.export``
program.  The corpus index travels beside it in the same ``.npz`` as the
program's arguments, not as constants, so it keeps its storage dtype
(fp32, bf16 as a ``uint16`` view, or int8 values with fp32 scales) and the
program's size does not grow with the corpus.  :class:`SearchArtifact`
loads and runs it with no model code, config or checkpoint: it imports
``crossclr_tpu_torch.ops`` alone, which registers ``crossclr::flash_fwd``
(kernel 1 as an operator; the program calls it once per attention layer
of a flash tower, so a search on a card launches the kernel).

Contract fixed at export time:
  * the query batch dimension is symbolic (``Dim("b")``): one artifact
    serves any batch size;
  * ``k`` is static; a smaller k takes the first columns (top-k is sorted
    descending, exact ties to the lowest index);
  * the scoring is the live service's, op for op;
  * the device type the program was exported on (``platforms``): it loads
    onto that device type only;
  * one device: a ``--shard-corpus`` service spans ranks that the
    consumer machine cannot be assumed to have.
"""

from __future__ import annotations

import copy
import io
import json

import numpy as np
import torch

__all__ = ["export_search", "save_artifact", "SearchArtifact"]

ARTIFACT_VERSION = 2


class _Search(torch.nn.Module):
    """The exported computation: ``(features, mask, values, scales) ->
    (scores [b, k], indices [b, k])``, ``mask`` None for pooled queries
    and ``scales`` None for a dense index."""

    def __init__(self, tower, transformer: bool, k: int):
        super().__init__()
        self.tower = tower
        self.transformer = transformer
        self.k = k

    def forward(self, features, mask, values, scales):
        from .evaluation.retrieval import QuantizedCorpus, _similarity, topk

        q = (self.tower(features, mask) if self.transformer
             else self.tower(features)).float()
        corpus = values if scales is None else QuantizedCorpus(values, scales)
        _, sim = _similarity(q, corpus)
        return topk(sim(slice(None)), self.k)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array: bf16 as its ``uint16`` bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def export_search(service, *, k: int,
                  query_shape: tuple[int, ...] | None = None):
    """Export ``service``'s search as ``(blob: bytes, meta: dict,
    corpus_parts: tuple[np.ndarray, ...])``, on the service's device.

    ``query_shape``: one query's trailing feature shape, ``(D,)`` for
    pooled features (the default, the query tower's input dim) or ``(S,
    D)`` for sequences, which adds a ``[b, S]`` mask argument."""
    from .evaluation import QuantizedCorpus

    if getattr(service, "group", None) is not None:
        raise ValueError(
            "cannot export a sharded-corpus service: the artifact must run "
            "on a consumer machine without these ranks (serve without "
            "--shard-corpus to export)"
        )
    k = int(min(k, service.corpus_rows))
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    cfg = service.query_cfg
    if query_shape is None:
        query_shape = (int(cfg.input_dim),)
    query_shape = tuple(int(d) for d in query_shape)
    with_mask = len(query_shape) == 2
    transformer = cfg.kind == "transformer"
    if with_mask != transformer:
        raise ValueError(
            f"query_shape {query_shape} does not fit the {cfg.kind} "
            f"{service.query_side} tower ({'S, D' if transformer else 'D'})"
        )
    # the tower alone, its parameters frozen: without autograd the flash
    # towers run through crossclr::flash_fwd, the operator export records
    tower = getattr(service.state.model, f"{service.query_side}_tower")
    tower = copy.deepcopy(tower).eval().requires_grad_(False)
    corpus = service.corpus_emb
    quantized = isinstance(corpus, QuantizedCorpus)
    parts = tuple(corpus) if quantized else (corpus,)
    dev = parts[0].device
    b = torch.export.Dim("b")
    feats = torch.zeros((2, *query_shape), device=dev)
    mask = torch.ones((2, query_shape[0]), device=dev) if with_mask else None
    args = (feats, mask, parts[0], parts[1] if quantized else None)
    dynamic = ({0: b}, {0: b} if with_mask else None, None, None)
    program = torch.export.export(_Search(tower, transformer, k), args,
                                  dynamic_shapes=dynamic)
    # the saved program would keep its example inputs, the index among
    # them: the index travels beside it instead
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    corpus_host = tuple(_host(p) for p in parts)
    meta = {
        "version": ARTIFACT_VERSION,
        "k": k,
        "query_side": service.query_side,
        "corpus_side": service.corpus_side,
        "corpus_rows": service.corpus_rows,
        "query_shape": list(query_shape),
        "with_mask": with_mask,
        "step": service.step,
        "platforms": [dev.type],
        "index_dtype": str(service.corpus_dtype).removeprefix("torch."),
        # npz has no bf16: such parts are stored as a uint16 view
        "corpus_dtypes": [str(p.dtype).removeprefix("torch.") for p in parts],
    }
    return buf.getvalue(), meta, corpus_host


def save_artifact(path: str, blob: bytes, meta: dict, corpus_parts: tuple,
                  ids: list[str] | None = None) -> None:
    """Write the artifact ``.npz``: the exported program, a JSON meta
    record, the index arrays, and (optionally) row-aligned corpus ids."""
    arrays = {
        "exported": np.frombuffer(blob, np.uint8),
        "meta": np.asarray(json.dumps(meta)),
    }
    for i, part in enumerate(corpus_parts):
        arrays[f"corpus_{i}"] = np.asarray(part)
    if ids is not None:
        arrays["ids"] = np.asarray(ids)
    np.savez(path, **arrays)


class SearchArtifact:
    """Load and run an exported search artifact with ``torch`` and
    ``numpy`` alone: no config, model code or checkpoint.  ``search``
    gives the HTTP service's result shape (``{"indices", "scores",
    "ids"?}``)."""

    def __init__(self, program, meta: dict, corpus_parts: tuple,
                 ids: list[str] | None = None, device=None):
        self.meta = meta
        self.ids = ids
        self.device = torch.device(device or meta["platforms"][0])
        # the index is placed on the device once and reused by every call
        self._corpus = tuple(corpus_parts)
        self._fn = program.module()

    @classmethod
    def load(cls, path: str, device=None) -> "SearchArtifact":
        """Load ``path`` onto ``device`` (default: the device type it was
        exported on); another device type is refused."""
        from . import ops  # noqa: F401  registers crossclr::flash_fwd

        with np.load(path, allow_pickle=False) as npz:
            meta = json.loads(str(npz["meta"]))
            exported_on = meta["platforms"][0]
            device = torch.device(device or exported_on)
            if device.type != exported_on:
                raise ValueError(
                    f"{path} was exported on {exported_on} and cannot run on "
                    f"{device.type}: export it again on that device type "
                    f"(export_serving --device {device.type})"
                )
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"{path} runs on a CUDA device; none is "
                                   "available")
            program = torch.export.load(io.BytesIO(npz["exported"].tobytes()))
            parts = []
            for i, dtype in enumerate(meta["corpus_dtypes"]):
                part = torch.from_numpy(np.ascontiguousarray(npz[f"corpus_{i}"]))
                if dtype == "bfloat16":
                    part = part.view(torch.bfloat16)
                parts.append(part.to(device))
            ids = [str(i) for i in npz["ids"]] if "ids" in npz else None
        return cls(program, meta, tuple(parts), ids, device)

    def search(self, features, mask=None, k: int | None = None) -> dict:
        """Top-k retrieval; ``k`` defaults to (and cannot exceed) the k
        fixed at export, a smaller k takes the first columns."""
        k_max = self.meta["k"]
        k = k_max if k is None else int(k)
        if not 0 < k <= k_max:
            raise ValueError(
                f"k={k} outside (0, {k_max}] baked into this artifact"
            )
        features = np.asarray(features, np.float32)
        if features.ndim == len(self.meta["query_shape"]):
            features = features[None]  # single-query convenience
        if self.meta["with_mask"]:
            if mask is None:
                mask = np.ones(features.shape[:2], np.float32)
            else:
                mask = np.asarray(mask, np.float32)
                if mask.ndim == 1:  # single-query convenience, as serve
                    mask = mask[None]
            mask = torch.from_numpy(mask).to(self.device)
        elif mask is not None:
            raise ValueError("this artifact's queries are pooled (no mask)")
        feats = torch.from_numpy(features).to(self.device)
        values = self._corpus[0]
        scales = self._corpus[1] if len(self._corpus) > 1 else None
        with torch.inference_mode():
            scores, idx = self._fn(feats, mask, values, scales)
        scores = scores[:, :k].cpu().numpy()
        idx = idx[:, :k].cpu().numpy()
        out = {"indices": idx.tolist(), "scores": scores.tolist()}
        if self.ids is not None:
            out["ids"] = [[self.ids[j] for j in row] for row in idx.tolist()]
        return out
