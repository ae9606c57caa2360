"""The port runs where jax is not installed.

A subprocess installs a ``sys.meta_path`` finder that makes any import of
``jax``, ``flax`` or the JAX package raise, then imports
``crossclr_tpu_torch``, builds the port's service on the CPU at a tiny
size and answers one search over HTTP; others train the MLP, the
transformer, the full-CrossCLR and the podslice configs (the full
CrossCLR one also imports the global-negative losses of
``crossclr_tpu_torch.parallel``; the podslice one trains through the
GradCache two-pass step, and once more on two ranks of a gloo group that
``parallel.initialize_multihost`` starts from the launcher's environment;
the transformer config on two ranks as a 1 × 2 grid of ring-attention
towers, ``parallel.mesh`` and ``parallel.ring_attention``, whose
checkpoint restores into flash towers, then of flash towers split by
``parallel.tensor_parallel`` and trained with LAMB),
and the MLP config from int8 and bf16 file stores, written by the port's
own quantizer and bf16 conversion, with ``ml_dtypes`` blocked too.  One
more drives the slice of serving what the port trains: the torch import
CLI writes a checkpoint, the eval CLI scores it, ``build_service`` serves
it from ``--checkpoint-dir`` with the int8 index behind a batching
window, the train CLI resumes from it, and one ``POST /reload`` picks the
new step up.  And an exported search artifact loads and searches with
jax blocked, importing none of the port's model, training or serving
code.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "crossclr_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import crossclr_tpu_torch
from crossclr_tpu_torch.data import SyntheticPairs
from crossclr_tpu_torch.serve import _make_handler, build_service
from crossclr_tpu_torch.utils.config import ExperimentConfig, apply_overrides

cfg = apply_overrides(ExperimentConfig(), [
    "video_tower.kind=transformer", "text_tower.kind=transformer",
    "video_tower.attention=flash", "text_tower.attention=flash",
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "video_tower.num_heads=2", "text_tower.num_heads=2",
    "video_tower.num_layers=1", "text_tower.num_layers=1",
    "video_tower.max_seq_len=4", "text_tower.max_seq_len=3",
    "data.num_pairs=16", "data.video_dim=12", "data.text_dim=10",
    "data.video_seq_len=4", "data.text_seq_len=3",
    "data.variable_lengths=true", "data.batch_size=8",
])
service = build_service(cfg, None, "video", random_params=True, device="cpu")
data = SyntheticPairs(num_pairs=16, video_dim=12, text_dim=10,
                      video_seq_len=4, text_seq_len=3, variable_lengths=True)
httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
thread = threading.Thread(target=httpd.serve_forever, daemon=True)
thread.start()
req = urllib.request.Request(
    f"http://127.0.0.1:{httpd.server_address[1]}/search",
    data=json.dumps({"features": data.text[:2].tolist(),
                     "mask": data.text_mask[:2].tolist(), "k": 3}).encode(),
    method="POST",
)
with urllib.request.urlopen(req) as resp:
    out = json.loads(resp.read())
httpd.shutdown()
httpd.server_close()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "crossclr_tpu"))
print(json.dumps({"indices": out["indices"], "loaded": loaded}))
"""


TRAIN_SCRIPT = SCRIPT.split("import json\n", 1)[0] + r"""
import importlib
import json
import pkgutil

import crossclr_tpu_torch
from crossclr_tpu_torch import train

modules = [m.name for m in pkgutil.walk_packages(crossclr_tpu_torch.__path__,
                                                 "crossclr_tpu_torch.")]
for name in modules:
    importlib.import_module(name)
rc = train.main([
    "--device", "cpu", "--steps", "4", "--metrics-csv", "metrics.csv",
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "data.num_pairs=64", "data.video_dim=12", "data.text_dim=10",
    "data.batch_size=16", "train.loss=crossclr_intra_fused",
    "train.learnable_temperature=true", "train.warmup_steps=1",
    "eval_every=2", "checkpoint_dir=ckpt",
])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                       "crossclr_tpu"))
print(json.dumps({"rc": rc, "modules": len(modules), "loaded": loaded}))
"""


TRANSFORMER_TRAIN_SCRIPT = SCRIPT.split("import json\n", 1)[0] + r"""
import json

from crossclr_tpu_torch import train

rc = train.main([
    "--config", CONFIG, "--device", "cpu", "--steps", "4",
    "--metrics-csv", "metrics.csv",
    "video_tower.attention=flash", "text_tower.attention=flash",
    "video_tower.dropout=0.1", "text_tower.dropout=0.1",
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "video_tower.num_layers=1", "text_tower.num_layers=1",
    "video_tower.num_heads=2", "text_tower.num_heads=2",
    "data.source=synthetic", "data.num_pairs=64", "data.video_dim=12",
    "data.text_dim=10", "data.video_seq_len=5", "data.text_seq_len=4",
    "data.variable_lengths=true", "data.batch_size=16",
    "train.warmup_steps=1", "eval_every=2", "checkpoint_dir=ckpt",
])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                       "crossclr_tpu"))
print(json.dumps({"rc": rc, "loaded": loaded}))
"""


FULL_CROSSCLR_SCRIPT = SCRIPT.split("import json\n", 1)[0] + r"""
import json

import crossclr_tpu_torch.parallel
from crossclr_tpu_torch import train

rc = train.main([
    "--config", CONFIG, "--device", "cpu", "--steps", "4",
    "--metrics-csv", "metrics.csv",
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "video_tower.num_layers=1", "text_tower.num_layers=1",
    "video_tower.num_heads=2", "text_tower.num_heads=2",
    "data.source=synthetic", "data.num_pairs=64", "data.video_dim=12",
    "data.text_dim=10", "data.video_seq_len=5", "data.text_seq_len=4",
    "data.variable_lengths=true", "data.batch_size=16",
    "train.warmup_steps=1", "train.steps_per_call=2", "eval_every=2",
    "checkpoint_dir=ckpt",
])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                       "crossclr_tpu"))
print(json.dumps({"rc": rc, "loaded": loaded}))
"""


PODSLICE_SCRIPT = SCRIPT.split("import json\n", 1)[0] + r"""
import json

from crossclr_tpu_torch import train
from crossclr_tpu_torch.training import Trainer

passes = []
encode_chunks = Trainer.encode_chunks
Trainer.encode_chunks = lambda *a: passes.append(1) or encode_chunks(*a)
rc = train.main([
    "--config", CONFIG, "--device", "cpu", "--steps", "4",
    "--metrics-csv", "metrics.csv",
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "data.source=synthetic", "data.num_pairs=72", "data.video_dim=12",
    "data.text_dim=10", "data.batch_size=32", "train.embedding_chunk=8",
    "train.warmup_steps=1", "train.steps_per_call=2", "eval_every=2",
    "checkpoint_dir=ckpt",
])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                       "crossclr_tpu"))
print(json.dumps({"rc": rc, "passes": len(passes), "loaded": loaded}))
"""


DATA_PARALLEL_SCRIPT = SCRIPT.split("import json\n", 1)[0] + r"""
import json
import os

from crossclr_tpu_torch import train

rank = os.environ["RANK"]
rc = train.main([
    "--config", CONFIG, "--device", "cpu", "--steps", "4",
    "--metrics-csv", f"metrics_{rank}.csv",
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "data.source=synthetic", "data.num_pairs=72", "data.video_dim=12",
    "data.text_dim=10", "data.batch_size=32", "train.embedding_chunk=8",
    "train.warmup_steps=1", "train.steps_per_call=2", "eval_every=2",
    "checkpoint_dir=ckpt",
])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                       "crossclr_tpu"))
print(json.dumps({"rc": rc, "loaded": loaded}))
"""


RING_SCRIPT = SCRIPT.split("import json\n", 1)[0] + r"""
import json
import os

import torch

from crossclr_tpu_torch import train
from crossclr_tpu_torch.models.encoders import DualEncoder
from crossclr_tpu_torch.utils.config import apply_overrides, load_config

rank = os.environ["RANK"]
tiny = [
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "video_tower.num_layers=1", "text_tower.num_layers=1",
    "video_tower.num_heads=2", "text_tower.num_heads=2",
    "video_tower.dropout=0.1", "text_tower.dropout=0.1",
    "data.source=synthetic", "data.num_pairs=48", "data.video_dim=12",
    "data.text_dim=10", "data.video_seq_len=8", "data.text_seq_len=6",
    "data.variable_lengths=true", "data.batch_size=16",
    "train.warmup_steps=1", "train.steps_per_call=1", "eval_every=2",
]
ring = ["video_tower.attention=ring", "text_tower.attention=ring"]
rc = train.main([
    "--config", CONFIG, "--device", "cpu", "--steps", "4", "--n-model", "2",
    "--metrics-csv", f"metrics_{rank}.csv", *tiny, *ring, "checkpoint_dir=ckpt",
])
cfg = apply_overrides(load_config(CONFIG), tiny + [
    "video_tower.attention=flash", "text_tower.attention=flash"])
flash = DualEncoder(cfg.video_tower, cfg.text_tower)
flash.load_state_dict(torch.load("ckpt/step_4.pt", weights_only=True)["model"])
# the same grid splitting flash towers tensor-parallel, LAMB under ZeRO-1
# (one data rank: inert), laid out by a forced DCN granule count of 1; its
# group meets on a port of its own (another process may have taken the
# first group's port since that group closed)
os.environ["MASTER_PORT"] = os.environ["TP_MASTER_PORT"]
rc_tp = train.main([
    "--config", CONFIG, "--device", "cpu", "--steps", "2", "--n-model", "2",
    "--mesh-dcn", "1", "--metrics-csv", f"metrics_tp_{rank}.csv", *tiny,
    "video_tower.attention=flash", "text_tower.attention=flash",
    "train.optimizer=lamb", "train.zero1=true", "checkpoint_dir=ckpt_tp",
])
flash.load_state_dict(torch.load("ckpt_tp/step_2.pt", weights_only=True)["model"])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                       "crossclr_tpu"))
print(json.dumps({"rc": rc, "rc_tp": rc_tp, "loaded": loaded,
                  "ring": "crossclr_tpu_torch.parallel.ring_attention" in sys.modules,
                  "tp": "crossclr_tpu_torch.parallel.tensor_parallel" in sys.modules}))
"""


STORE_SCRIPT = SCRIPT.split("import json\n", 1)[0].replace(
    '"crossclr_tpu")', '"crossclr_tpu", "ml_dtypes")') + r"""
import json

import numpy as np

from crossclr_tpu_torch import train
from crossclr_tpu_torch.data import SyntheticPairs, f32_to_bf16, quantize_features

data = SyntheticPairs(num_pairs=64, video_dim=12, text_dim=10)
for name in ("video", "text"):
    x = getattr(data, name)
    if DTYPE == "int8":
        q, scale = quantize_features(x)
        np.save(f"{name}.npy", q)
        np.save(f"{name}_scale.npy", scale)
    else:
        np.save(f"{name}.npy", f32_to_bf16(x))
rc = train.main([
    "--device", "cpu", "--steps", "4", "--metrics-csv", "metrics.csv",
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "data.source=files", "data.video_path=video.npy", "data.text_path=text.npy",
    f"data.features_dtype={DTYPE}", "data.batch_size=16",
    "train.warmup_steps=1", "train.steps_per_call=2", "eval_every=2",
    "checkpoint_dir=ckpt",
])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                       "crossclr_tpu", "ml_dtypes"))
print(json.dumps({"rc": rc, "loaded": loaded}))
"""


SERVE_CHECKPOINT_SCRIPT = SCRIPT.split("import json\n", 1)[0] + r"""
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import torch

from crossclr_tpu_torch import eval as teval
from crossclr_tpu_torch import import_torch_checkpoint, train
from crossclr_tpu_torch.data import SyntheticPairs
from crossclr_tpu_torch.models import DualEncoder
from crossclr_tpu_torch.serve import _make_handler, build_service
from crossclr_tpu_torch.utils.config import ExperimentConfig, apply_overrides

overrides = [
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "data.num_pairs=64", "data.video_dim=12", "data.text_dim=10",
    "data.batch_size=16", "train.warmup_steps=1", "eval_every=2",
    "checkpoint_dir=ckpt",
]
cfg = apply_overrides(ExperimentConfig(), overrides)
towers = DualEncoder(cfg.video_tower, cfg.text_tower)
torch.save({f"{side}_tower.{k}": v for side in ("video", "text")
            for k, v in getattr(towers, f"{side}_tower").state_dict().items()},
           "towers.pt")
rcs = [import_torch_checkpoint.main(["--torch-ckpt", "towers.pt", "--output",
                                     "ckpt", *overrides])]
rcs.append(teval.main(["--device", "cpu", "--split", "all",
                       "--output", "metrics.json", *overrides]))
service = build_service(cfg, "ckpt", "video", device="cpu", corpus_dtype="int8",
                        batch_window_ms=5.0)
rcs.append(train.main(["--device", "cpu", "--steps", "2", *overrides]))
httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
thread = threading.Thread(target=httpd.serve_forever, daemon=True)
thread.start()
url = f"http://127.0.0.1:{httpd.server_address[1]}"
data = SyntheticPairs(num_pairs=64, video_dim=12, text_dim=10)
replies = []
for path, body in (("/search", {"features": data.text[:2].tolist(), "k": 3}),
                   ("/reload", {}),
                   ("/search", {"features": data.text[:2].tolist(), "k": 3})):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        replies.append(json.loads(resp.read()))
httpd.shutdown()
httpd.server_close()
service._batcher.close()
with open("metrics.json") as fh:
    metrics = json.load(fh)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                       "crossclr_tpu"))
print(json.dumps({"rcs": rcs, "eval_step": metrics["step"],
                  "rows": metrics["rows"], "replies": replies,
                  "dispatches": service.stats()["search_dispatches"],
                  "loaded": loaded}))
"""


def test_port_serves_what_it_trains_without_jax(tmp_path):
    """The import CLI's checkpoint → the eval CLI → ``build_service`` from
    the checkpoint directory (int8 index, 5 ms batching window) → the train
    CLI resumed from it → ``POST /reload``, with jax, flax, optax, orbax
    and the JAX package blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_CHECKPOINT_SCRIPT], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loaded"] == [] and result["rcs"] == [0, 0, 0]
    assert result["eval_step"] == 0 and result["rows"] == 64
    before, reload, after = result["replies"]
    assert reload == {"status": "ok", "step": 2, "index_step": 2}
    for out in (before, after):
        assert np.asarray(out["indices"]).shape == (2, 3)
    assert before["scores"] != after["scores"]
    assert result["dispatches"] == 2
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_0.pt", "step_2.pt"]


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_port_trains_from_file_stores_without_jax(tmp_path, dtype):
    """The MLP config trains from an int8 and from a bf16 file store,
    pre-stacked at ``steps_per_call=2``, evaluates and checkpoints with jax,
    flax, optax, orbax, the JAX package and ml_dtypes blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", STORE_SCRIPT.replace("DTYPE", repr(dtype))],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "loaded": []}
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_2.pt", "step_4.pt"]


def test_port_trains_the_podslice_config_without_jax(tmp_path):
    """The podslice config (MLP towers, ``crossclr_intra_fused``,
    ``embedding_chunk``, ``zero1`` and ``global_negatives`` inert on one
    device) trains through the two-pass step, evaluates and checkpoints
    with jax, flax, optax and orbax blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = PODSLICE_SCRIPT.replace(
        "CONFIG", repr(str(REPO / "configs" / "podslice_32k.json")))
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "passes": 4, "loaded": []}
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_2.pt", "step_4.pt"]


def test_port_trains_on_two_ranks_without_jax(tmp_path):
    """The podslice config on two gloo ranks (``--device cpu``) that the
    train CLI joins from ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and a free ``MASTER_PORT`` (global negatives, ZeRO-1,
    the two-pass step at 16 rows a rank) with jax, flax, optax and orbax
    blocked; rank 0 alone writes the metrics and the checkpoints."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = DATA_PARALLEL_SCRIPT.replace(
        "CONFIG", repr(str(REPO / "configs" / "podslice_32k.json")))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(REPO), RANK=str(rank),
                 LOCAL_RANK=str(rank), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert json.loads(out.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}
    assert (tmp_path / "metrics_0.csv").exists()
    assert not (tmp_path / "metrics_1.csv").exists()
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_2.pt", "step_4.pt"]


def test_port_trains_ring_towers_on_a_grid_without_jax(tmp_path):
    """The transformer config's ring-attention towers with dropout on two
    gloo ranks as a 1 × 2 grid (``--n-model 2``) that the train CLI joins
    from the launcher's environment, with jax, flax, optax and orbax
    blocked: rank 0 alone writes the metrics and the checkpoints, and a
    checkpoint loads into flash towers; then flash towers split
    tensor-parallel on the same grid (``parallel.tensor_parallel``), LAMB,
    ``--mesh-dcn``, whose whole checkpoint loads the same way."""
    with socket.socket() as s, socket.socket() as s_tp:
        s.bind(("127.0.0.1", 0))
        s_tp.bind(("127.0.0.1", 0))
        port, tp_port = s.getsockname()[1], s_tp.getsockname()[1]
    script = RING_SCRIPT.replace(
        "CONFIG", repr(str(REPO / "configs" / "lsmdc_transformer.json")))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(REPO), RANK=str(rank),
                 LOCAL_RANK=str(rank), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 TP_MASTER_PORT=str(tp_port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert json.loads(out.strip().splitlines()[-1]) == {
            "rc": 0, "rc_tp": 0, "loaded": [], "ring": True, "tp": True}
    assert (tmp_path / "metrics_0.csv").exists()
    assert not (tmp_path / "metrics_1.csv").exists()
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_2.pt", "step_4.pt"]
    assert (tmp_path / "metrics_tp_0.csv").exists()
    assert not (tmp_path / "metrics_tp_1.csv").exists()


def test_port_trains_full_crossclr_without_jax(tmp_path):
    """The full-CrossCLR config (ragged transformer towers, the
    ``crossclr_fused`` loss with learnable τ) trains, evaluates and
    checkpoints with jax, flax, optax and orbax blocked; the global-loss
    package imports."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = FULL_CROSSCLR_SCRIPT.replace(
        "CONFIG", repr(str(REPO / "configs" / "fullcrossclr_fused_ragged.json")))
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "loaded": []}
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_2.pt", "step_4.pt"]


def test_port_trains_transformer_towers_without_jax(tmp_path):
    """The transformer config trains (flash attention with dropout),
    evaluates and checkpoints with jax, flax, optax and orbax blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = TRANSFORMER_TRAIN_SCRIPT.replace(
        "CONFIG", repr(str(REPO / "configs" / "lsmdc_transformer.json")))
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "loaded": []}
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_2.pt", "step_4.pt"]


def test_port_trains_without_jax(tmp_path):
    """Every module of the port imports, and the training CLI trains,
    evaluates and checkpoints, with jax, flax, optax and orbax blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN_SCRIPT], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "modules": result["modules"], "loaded": []}
    assert result["modules"] >= 20
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_2.pt", "step_4.pt"]


def test_port_serves_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    idx = result["indices"]
    assert len(idx) == 2 and all(len(r) == 3 for r in idx)
    assert all(0 <= i < 16 for r in idx for i in r)


LOAD_SCRIPT = SCRIPT.split("import json\n", 1)[0] + r"""
import json

import numpy as np

from crossclr_tpu_torch.aot import SearchArtifact

art = SearchArtifact.load("art.npz")
out = art.search(np.ones((2, 3, 10), np.float32), np.ones((2, 3), np.float32))
port = sorted(m for m in sys.modules if m.startswith("crossclr_tpu_torch."))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "crossclr_tpu"))
print(json.dumps({"indices": out["indices"], "port": port, "loaded": loaded}))
"""


def test_port_exports_and_loads_an_artifact_without_jax(tmp_path):
    """A flash-tower search artifact written by the export CLI (here; every
    module of the port imports with jax blocked in
    ``test_port_trains_without_jax``) loads and searches in a process with
    jax blocked that imports no model, training, serving or data code of
    the port: the operator package and the losses it imports alone."""
    from crossclr_tpu_torch import export_serving, train

    overrides = [
        "video_tower.kind=transformer", "text_tower.kind=transformer",
        "video_tower.attention=flash", "text_tower.attention=flash",
        "video_tower.input_dim=12", "text_tower.input_dim=10",
        "video_tower.embed_dim=8", "text_tower.embed_dim=8",
        "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
        "video_tower.num_heads=2", "text_tower.num_heads=2",
        "video_tower.num_layers=1", "text_tower.num_layers=1",
        "video_tower.max_seq_len=4", "text_tower.max_seq_len=3",
        "data.num_pairs=16", "data.video_dim=12", "data.text_dim=10",
        "data.video_seq_len=4", "data.text_seq_len=3", "data.batch_size=8",
    ]
    cfg = str(tmp_path / "cfg.json")
    assert train.main(["--save-config", cfg, "--device", "cpu", *overrides]) == 0
    assert export_serving.main(["--config", cfg, "--random-params", "--device", "cpu",
                                "--k", "3", "--query-shape", "3,10",
                                "--output", str(tmp_path / "art.npz")]) == 0
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_SCRIPT], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    served = json.loads(proc.stdout.strip().splitlines()[-1])
    assert served["loaded"] == []
    assert {m.split(".")[1] for m in served["port"]} == {"aot", "ops", "losses"}
    assert np.asarray(served["indices"]).shape == (2, 3)
