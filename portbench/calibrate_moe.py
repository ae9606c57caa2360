"""Readings that the output check's limits of a cell with an ``mla_moe``
text tower are set from, on the chip.

  python3 portbench/calibrate_moe.py --workload moonlight_train \\
      --seeds 1,2,... --controls 1,2 --seconds 2

runs the cell once a seed in one process (a short window) and prints the
program's numbers of the output check, one JSON line a seed (the lower
readings).  For each seed of ``--controls`` it also puts the reference in
the program's place and judges it as the run judges the program, routed
by that stand-in's own choices: computed in float8 (e4m3, per-tensor
scales: the precision below the bf16 the configuration states), and with
each planted routing fault (``no_bias``: the correction bias left out of
the choice; ``unnormalised``: the weights left unnormalised).  Each must
read above a limit.  The lines go to stdout, and are appended to ``--out``
where given.  Not part of a benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(ROOT))

CONTROLS = (("fp8", {"precision": "fp8"}), ("no_bias", {"fault": "no_bias"}),
            ("unnormalised", {"fault": "unnormalised"}))


def controls(args: tuple, kw: dict, run) -> dict:
    """``{control: numbers}``: the reference in the program's place (its own
    choices), judged by the reference routed by those choices."""
    from portbench import judge

    out = {}
    for name, extra in CONTROLS:
        stand_in = run(*args, **{**kw, "routes": None, **extra})
        ref = run(*args, **{**kw, "routes": stand_in["routes"]})
        out[name] = {**judge.training(stand_in, ref), "route_margin": ref["route_margin"]}
    return out


def _ints(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--controls", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None, help="a JSON-lines file to append to")
    args = parser.parse_args(argv)
    from portbench import harness, judge
    from portbench.reference import mla_moe

    captured: dict = {}
    original_run = mla_moe.run

    def capture(*a, **kw):
        result = original_run(*a, **kw)
        captured.update(args=a, kw=kw)
        return result

    original_judge = judge.training

    def capture_judge(prog, ref):
        captured.update(prog=prog, ref=ref)
        return original_judge(prog, ref)

    mla_moe.run = capture
    judge.training = capture_judge
    sink = open(args.out, "a") if args.out else None
    control_seeds = set(_ints(args.controls))
    print(f"portbench: {harness.card_power()}", file=sys.stderr)
    for seed in _ints(args.seeds):
        captured.clear()
        t0 = time.perf_counter()
        result = harness.execute(args.workload, seed, args.seconds, False, t_start=t0)
        line = {"workload": args.workload, "seed": seed, "what": "program",
                "correct": result["correct"], "checks": result["checks"],
                "metrics": result["metrics"], "failed": result["failed"],
                "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                "run_s": time.perf_counter() - t0}
        if "prog" in captured:
            line["worst"] = {key: judge.worst_leaves(captured["prog"], captured["ref"], key)
                             for key in ("grad_norms", "change_norms")}
        lines = [line]
        if seed in control_seeds:
            t1 = time.perf_counter()
            judge.training = original_judge
            for name, numbers in controls(captured["args"], captured["kw"],
                                          original_run).items():
                lines.append({"workload": args.workload, "seed": seed, "what": name,
                              "numbers": numbers, "run_s": time.perf_counter() - t1})
            judge.training = capture_judge
        for ln in lines:
            text = json.dumps(ln)
            print(text, flush=True)
            if sink is not None:
                sink.write(text + "\n")
                sink.flush()
        captured.clear()
    if sink is not None:
        sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
