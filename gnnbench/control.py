"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size (no measured window: the check reads only the
first steps):

    python3 gnnbench/control.py --workload sage-products-b1000 \\
        --seeds 11 12 13 [--out chiprun_out/control.jsonl]

For each seed, one JSON line: the compared numbers of the program against
the float32 reference, of the control (the reference with TF32 matrix
products) and of a fault (half of the trainers' batches left out of the
step's mean), each against the same float32 reference, with the sampling
and staging fault counts. With ``--look``, also the first step leaf by
leaf: the program's gradient and update, the reference's with ordered and
with atomic sums, each against the same gradient in float64 on the host
(PERF.md, section 4: what the look found). The benchmark's own runs never
run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def look(cell, st, decoded, device) -> list:
    """The first step leaf by leaf: the program's gradient (from AdamW's
    first moment) and its update against the reference's (ordered sums),
    the reference with atomic sums against it, and all three against the
    float64 gradient."""
    import torch

    from gnnbench.reference import check, model

    forward = cell.arch.forward
    opt = cell.config["optimizer"]
    b1, lr = float(opt["betas"][0]), float(opt["lr"])
    samples = check.to_device(decoded.samples[0], device)
    params = model.tree_map(lambda p: p.to(device).float(), st.params0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    _, ref = model.loss_and_grads(forward, params, samples)
    torch.use_deterministic_algorithms(False)
    _, atomic = model.loss_and_grads(forward, params, samples)
    step = model.AdamW(params, lr, tuple(opt["betas"]), float(opt["eps"]),
                       float(opt["weight_decay"])).step(params, ref)
    # the same gradient in float64 on the host, the arbiter
    f64 = check.to_device(decoded.samples[0], "cpu")
    for s in f64:
        s["feats"] = s["feats"].double()
    _, exact = model.loss_and_grads(
        forward, model.tree_map(lambda p: p.double(), st.params0), f64)
    prog = dict(model.leaves(st.first.moment1))
    prog1 = dict(model.leaves(st.first.params1))
    start = dict(model.leaves(st.params0))
    rows = []
    for (path, g), (_, a), (_, p1), (_, x) in zip(
            model.leaves(ref), model.leaves(atomic), model.leaves(step),
            model.leaves(exact)):
        gp = prog[path].to(device) / (1 - b1)
        norm = float(g.norm())
        rms = float(g.pow(2).mean().sqrt())
        up_ref = p1 - start[path].to(device)
        up_prog = prog1[path].to(device) - start[path].to(device)
        rows.append({
            "leaf": "/".join(map(str, path)), "numel": g.numel(),
            "norm": norm, "prog_norm": float(gp.norm()),
            "diff": float((gp - g).norm()) / max(norm, 1e-30),
            "atomic_diff": float((a - g).norm()) / max(norm, 1e-30),
            "sign_flips": int(((gp.sign() != g.sign()) & (g != 0)).sum()),
            "tiny": int((g.abs() < 1e-3 * rms).sum()),
            "update_off": int(((up_prog - up_ref).abs() > lr / 2).sum()),
            "update_diff": float((up_prog - up_ref).norm()),
            "f64": {k: [float((v.double().cpu() - x).norm() / x.norm()),
                        float(abs(v.double().norm().cpu() - x.norm())
                              / x.norm())]
                    for k, v in (("program", gp), ("reference", g),
                                 ("atomic", a))}})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--look", action="store_true",
                    help="also compare the first step leaf by leaf")
    args = ap.parse_args(argv)

    import torch

    from gnnbench import harness

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        st = harness.setup(cell, seed, "cuda", log, steady=False)
        setup_s = time.perf_counter() - t
        harness.free(st)
        values, decoded = harness.check_first_steps(cell, st, "cuda", log)
        line = {"workload": cell.name, "seed": seed, "setup_s": setup_s,
                "faults": {k: v for k, v in values.items()
                           if k.endswith("_faults")},
                **harness.control_readings(cell, st, decoded, "cuda")}
        if args.look:
            line["look"] = look(cell, st, decoded, "cuda")
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
