"""Readings the limits of ``correct`` are set from, for one cell, in one
process (the kernels built once).

    python3 bench_port/calibrate.py --workload deepfm-criteo.steady \
        --seeds 11,12,13 --control-seeds 11,12,13

For every seed: the cell's set-up at its own size, through the program's
first steps, then the cell's check of the program (``loop.check``). For
every control seed also the control's numbers (the reference with its
tower in fp8, put in the program's place) and three planted faults' (the
reference with half of each batch left out of the step, the mean taken
over the rest: ``half_batch``; the same left out of the loss alone:
``half_loss``; the reference's first AUC tables with every prediction in
one bucket, that of the batch's mean). One JSON line a seed, then one
with each number's largest program reading and smallest control and
fault readings. The limits go in ``bench_port/limits/<cell>.json``; the
benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import shutil
import tempfile
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_port.core import checks, manifest  # noqa: E402
from bench_port.core.runner import _prepare_device  # noqa: E402
from bench_port.reference.common import auc_buckets, fp8_linear  # noqa: E402


def readings(name: str, seeds, control_seeds, device: str = "cuda", overrides=None):
    """Yield one dict a seed, then the summary."""
    bench = manifest.load_benchmark()
    wl = manifest.workload(bench, name)
    cfg = {**manifest.config(bench, wl["config"]), **(overrides or {}).get("config", {})}
    mix = {**manifest.traffic(wl["traffic"]), **(overrides or {}).get("traffic", {}), "warm_calls": 0}
    dev = torch.device(device)
    _prepare_device(dev)
    loop = manifest.module("loops", mix["loop"])

    def checked_run(seed):
        tmpdir = tempfile.mkdtemp(prefix="bench_port_cal_")
        try:
            ctx = SimpleNamespace(name=name, cfg=cfg, mix=mix, seed=seed, device=dev, tmpdir=tmpdir,
                                  chips=wl["chips"], model_mod=manifest.module("models", cfg["model"]),
                                  ref_mod=manifest.module("reference", cfg["model"]))
            run = loop.setup(ctx)
            loop.release(run)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            return run, loop.check(run)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)

    def one_bucket(run, ref):
        """``ref`` with every first-step prediction in one bucket."""
        p = run.prog["preds"][0]
        tables = auc_buckets(np.full_like(p, p.mean()), loop.batch(run, 0)["labels"], cfg["auc_buckets"])
        return {**ref, "auc1": tables}

    summary = {"program": {}, "control": {}, "half_batch": {}, "half_loss": {}, "auc_one_bucket": {}}
    for seed in seeds:
        run, numbers = checked_run(seed)
        line = {"seed": seed, "program": numbers}
        if seed in control_seeds:
            ref = loop.reference(run)
            line["control"] = checks.compare(loop.reference(run, linear=fp8_linear), ref)
            line["half_batch"] = checks.compare(loop.reference(run, step_share=0.5), ref)
            line["half_loss"] = checks.compare(loop.reference(run, loss_share=0.5), ref)
            line["auc_one_bucket"] = checks.compare(one_bucket(run, ref), ref)
        for side in summary:
            pick = max if side == "program" else min
            for n, v in line.get(side, {}).items():
                if isinstance(v, float):
                    summary[side][n] = v if n not in summary[side] else pick(summary[side][n], v)
        yield line
        del run
        gc.collect()
    yield {"summary": summary, "seeds": list(seeds), "control_seeds": sorted(control_seeds)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for line in readings(args.workload, seeds, control):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
