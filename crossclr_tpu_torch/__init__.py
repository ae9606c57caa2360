"""crossclr_tpu_torch — the PyTorch/CUDA port of ``crossclr_tpu`` for one
NVIDIA H100.

The JAX package stays the reference; each module here keeps the name of
its JAX counterpart so a reader can find it.  The port imports ``torch``
and never ``jax`` or ``flax``.

Layout:
  ops/         the hand-written CUDA kernels for sm_90a (flash attention,
               the fused loss pairs, the rows and per-direction kernels),
               each beside its plain PyTorch version
  models/      video / text towers as ``nn.Module``s
  data/        synthetic and file-backed feature stores, the native gather,
               the prefetch to the device
  training/    the trainer, its optimizer and checkpoints
  evaluation/  cosine top-k retrieval (dense and int8 indexes), R@K / MdR
  losses/      the CrossCLR losses
  parallel/    the launcher's ranks and the global-negative losses
  utils/       configs, the Flax → torch bridge, the torch tower import
  train.py, eval.py, serve.py, import_torch_checkpoint.py: the CLIs
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
