#!/usr/bin/env python3
"""Smoke run of the PyTorch port (crossclr_tpu_torch) on one NVIDIA GPU.

Drives the port's retrieval-serving path once, at the full width of
configs/lsmdc_transformer.json with attention="flash" on both towers, and
proves that the path went through the repo's own CUDA kernel.  Phases,
one line each; any failure raises and exits non-zero:

  1. device  — a CUDA device must exist (there is no CPU path); prints
               nvidia-smi's name and power limit, torch and CUDA versions.
  2. build   — builds the flash-attention forward from
               crossclr_tpu_torch/ops/csrc/flash_fwd.cu with nvcc for
               sm_90a; prints the time, the .so path and ptxas' report.
  3. kernel  — kernel against the plain version on the same CUDA tensors
               (H=8, Dh=48, S in {64, 96, 37}, ragged masks, one entry
               fully masked; fp32 and bf16) within the stated limits, then
               both timed at the serve encode shape (B=1024, H=8, S=96,
               Dh=48, bf16; CUDA events, median of 20).
  4. slice   — the port's build_service with seeded random weights on
               cuda (4096 synthetic pairs, video corpus, text queries),
               served by a ThreadingHTTPServer on 127.0.0.1:0; 8 POST
               /search (1, 3, 5, 16 query rows, k=10), GET /healthz and
               /metrics.  Checks HTTP 200, shapes, index range, descending
               scores in [-1, 1], that the kernel's launch count grew
               during the corpus encode and during every search, and that
               query embeddings from the kernel path have cosine >= 0.999
               with the same weights run through the plain attention.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.

Run from the root of a checkout:  python3 chip_smoke.py
"""

import copy
import importlib
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "crossclr_tpu_torch/ops/csrc/flash_fwd.cu"
REPLACES = "crossclr_tpu/ops/flash_attention.py:201"
OVERRIDES = [
    "video_tower.attention=flash", "text_tower.attention=flash",
    "data.source=synthetic", "data.num_pairs=4096", "data.video_dim=512",
    "data.text_dim=768", "data.video_seq_len=64", "data.text_seq_len=96",
    "data.variable_lengths=true", "data.batch_size=1024",
]
# kernel vs plain: (out atol, out rtol, lse atol).  fp32: the same sums in
# another order; bf16: the output rounds to bf16 (one ulp near 1 is 7.8e-3)
LIMITS = {
    torch.float32: (2e-5, 0.0, 1e-5),
    torch.bfloat16: (1.6e-2, 1.6e-2, 1e-3),
}
COSINE_MIN = 0.999
SCORE_SLACK = 1e-5  # a cosine of unit fp32 vectors may exceed 1 by rounding
SERVE_SHAPE = (1024, 8, 96, 48)  # (B, H, S, Dh) of one text-tower encode


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an NVIDIA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
                  f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    return smi


def build_phase() -> None:
    from crossclr_tpu_torch.ops import _build

    _build.load_library("flash_fwd.cu")
    info = _build.build_info["flash_fwd.cu"]
    log("build", f"nvcc {' '.join(_build.NVCC_FLAGS)} -> {info['path']} in "
                 f"{info['seconds']:.2f} s (built={info['built']})")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())


def ragged_mask(b: int, s: int, gen: torch.Generator) -> torch.Tensor:
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None]).float()
    mask[-1] = 0.0  # one batch entry with no valid key
    return mask


def qkv(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    return q, k, v, ragged_mask(shape[0], shape[2], gen)


def compare(fa, q, k, v, mask, tag: str) -> float:
    with torch.inference_mode():
        out, lse = fa.flash_attention_fwd(q, k, v, mask)
        ref, ref_lse = fa.mha_reference(q, k, v, mask, return_lse=True)
    torch.cuda.synchronize()
    atol, rtol, lse_atol = LIMITS[q.dtype]
    diff = (out.float() - ref.float()).abs()
    out_err = diff.max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    log("kernel", f"{tag}: max|out-plain| {out_err:.3e} (atol {atol}, rtol "
                  f"{rtol}), max|lse-plain| {lse_err:.3e} (atol {lse_atol})")
    check(bool(torch.isfinite(out.float()).all()), f"{tag}: non-finite output")
    check(bool((diff <= atol + rtol * ref.float().abs()).all()),
          f"{tag}: output outside the limit")
    check(lse_err <= lse_atol, f"{tag}: lse outside the limit")
    check(bool((out[-1] == 0).all()), f"{tag}: fully masked entry not zero")
    check(bool((lse[-1] == fa.MAX_FLOOR).all()), f"{tag}: fully masked lse")
    return out_err


def median_ms(fn, n: int = 20) -> float:
    with torch.inference_mode():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(fa, smi: str) -> dict:
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for s in (64, 96, 37):
            q, k, v, mask = qkv((4, 8, s, 48), dtype, seed=s)
            worst = max(worst, compare(fa, q, k, v, mask,
                                       f"{str(dtype)[6:]} S={s}"))
    q, k, v, mask = qkv(SERVE_SHAPE, torch.bfloat16, seed=1)
    worst = max(worst, compare(fa, q, k, v, mask, "bfloat16 serve shape"))
    ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v, mask))
    plain_ms = median_ms(lambda: fa.mha_reference(q, k, v, mask))
    log("kernel", f"B,H,S,Dh={SERVE_SHAPE} bf16: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (median of 20; {smi})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def post(url: str, payload: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        url + "/search", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def get(url: str, path: str) -> tuple[int, dict]:
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def check_result(out: dict, rows: int, k: int, corpus_rows: int) -> None:
    idx, scores = out["indices"], out["scores"]
    check(len(idx) == rows and all(len(r) == k for r in idx), "index shape")
    check(len(scores) == rows and all(len(r) == k for r in scores), "score shape")
    check(all(0 <= i < corpus_rows for r in idx for i in r), "index range")
    for row in scores:
        check(row == sorted(row, reverse=True), "scores not descending")
        check(all(abs(x) <= 1.0 + SCORE_SLACK for x in row), "score outside [-1, 1]")


def slice_phase(fa, smi: str) -> int:
    from crossclr_tpu_torch.data import dataset_from_config
    from crossclr_tpu_torch.eval import _encode_split
    from crossclr_tpu_torch.models import encoders
    from crossclr_tpu_torch.serve import _make_handler, build_service
    from crossclr_tpu_torch.training import TrainState
    from crossclr_tpu_torch.utils.config import apply_overrides, load_config

    cfg = apply_overrides(load_config(ROOT / "configs/lsmdc_transformer.json"),
                          OVERRIDES)
    fa.launch_count = 0  # every count starts here, just before the main path
    t0 = time.perf_counter()
    service = build_service(cfg, None, "video", random_params=True,
                            device="cuda")
    torch.cuda.synchronize()
    encode_launches = fa.launch_count
    log("slice", f"build_service (4096 synthetic pairs, both towers encoded) "
                 f"{time.perf_counter() - t0:.2f} s, corpus "
                 f"{tuple(service.corpus_emb.shape)}, kernel launches "
                 f"{encode_launches}")
    check(encode_launches > 0, "corpus encode launched no kernel")
    check(bool(torch.isfinite(service.corpus_emb).all()), "non-finite corpus")

    data, _ = dataset_from_config(cfg.data)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        start = 0
        for rows in (1, 3, 5, 16) * 2:
            before = fa.launch_count
            status, out = post(url, {
                "features": data.text[start:start + rows].tolist(),
                "mask": data.text_mask[start:start + rows].tolist(), "k": 10,
            })
            check(status == 200, f"/search answered {status}")
            check_result(out, rows, 10, service.corpus_rows)
            check(fa.launch_count > before, "a search launched no kernel")
            start += rows
        status, health = get(url, "/healthz")
        check(status == 200 and health["corpus_rows"] == 4096, "/healthz")
        status, metrics = get(url, "/metrics")
        check(status == 200 and metrics["search_requests"] == 8
              and metrics["search_errors"] == 0, "/metrics")
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = fa.launch_count
    log("slice", f"8 searches answered; kernel launches in the main path "
                 f"{launches} (corpus encode {encode_launches}); /metrics "
                 f"p50 {metrics['latency_ms']['p50']} ms ({smi})")

    # the same weights through the plain attention, called explicitly
    feats, mask = data.text[:16], data.text_mask[:16]
    plain_model = copy.deepcopy(service.state.model)
    for m in plain_model.modules():
        if isinstance(m, encoders._MHA):
            m.attend = fa.mha_reference
    trainer = service.trainer
    fast = trainer.encode_modality(service.state, "text", feats, mask)
    plain = trainer.encode_modality(TrainState(0, plain_model), "text", feats, mask)
    cos = torch.nn.functional.cosine_similarity(fast, plain, dim=1)
    log("slice", f"query embeddings kernel vs plain attention: min cosine "
                 f"{cos.min().item():.6f} (limit {COSINE_MIN})")
    check(bool((cos >= COSINE_MIN).all()), "kernel path disagrees with plain")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _encode_split(trainer, service.state, data, cfg.data.batch_size)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log("slice", f"corpus encode (video + text towers, batch 1024): "
                 f"{len(data) / seconds:.1f} rows/s over {len(data)} rows ({smi})")
    return launches


def main() -> int:
    smi = device_phase()
    sys.path.insert(0, str(ROOT))
    fa = importlib.import_module("crossclr_tpu_torch.ops.flash_attention")
    build_phase()
    kernel = kernel_phase(fa, smi)
    launches = slice_phase(fa, smi)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, **kernel,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
