"""crossclr_tpu_torch — the PyTorch/CUDA port of ``crossclr_tpu`` for one
NVIDIA H100.

The JAX package stays the reference; each module here keeps the name of
its JAX counterpart so a reader can find it.  The port imports ``torch``
and never ``jax`` or ``flax``.

Layout (the retrieval-serving slice):
  ops/         the flash-attention forward: a hand-written CUDA kernel for
               sm_90a beside its plain PyTorch version
  models/      video / text towers as ``nn.Module``s
  data/        synthetic and file-backed feature datasets, batching
  training/    ``TrainConfig`` and the trainer's init/encode surface
  evaluation/  cosine top-k retrieval
  losses/      ``l2_normalize``
  utils/       configs and the Flax → torch weight bridge
  eval.py      split encoding;  serve.py  the HTTP retrieval service
"""

__version__ = "0.1.0"

# every subpackage is imported lazily: importing the package needs no CUDA,
# no compiler and builds nothing
_SUBMODULES = (
    "ops",
    "models",
    "data",
    "training",
    "evaluation",
    "losses",
    "utils",
)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [*_SUBMODULES, "__version__"]
