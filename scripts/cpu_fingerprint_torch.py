#!/usr/bin/env python3
"""Fingerprint the port's CPU outputs so that two source trees can be
held bit for bit against each other (a refactor of the serial helpers
must leave every serial and fleet result unchanged).

    PYTHONPATH=src python3 scripts/cpu_fingerprint_torch.py a.json
    PYTHONPATH=OTHER/src python3 scripts/cpu_fingerprint_torch.py b.json
    python3 scripts/cpu_fingerprint_torch.py --compare a.json b.json

One seeded least-squares problem (n = 60, p = 300, 10 true features) and
its sign labels: ``saif`` under the saif, gap_safe and hybrid rules
(least squares through the torch and gram inner backends, logistic
through torch), a 3-problem ``fleet_solve`` (torch, gram, weighted), a
3-point ``saif_path``, ``dynamic_screening``, ``sequential_path``,
``homotopy_path`` and a 3-fold ``cv_solve``; each key hashes the
result's tensors (betas, gaps, outer steps, traces).
"""
import argparse
import hashlib
import json

import numpy as np
import torch


def fingerprints():
    import repro_torch as rt
    out = {}

    def put(key, *ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(torch.as_tensor(t).detach().cpu().contiguous()
                     .numpy().tobytes())
        out[key] = h.hexdigest()[:16]

    def tensors(res):
        return [getattr(res, f) for f in res._fields
                if torch.is_tensor(getattr(res, f))]

    r = np.random.default_rng(0)
    n, p = 60, 300
    X = torch.from_numpy(r.normal(size=(n, p)))
    bt = np.zeros(p)
    bt[:10] = r.uniform(-1, 1, 10)
    y = torch.from_numpy(X.numpy() @ bt + 0.1 * r.normal(size=n))
    yl = torch.sign(y)
    ls, lg = rt.get_loss("least_squares"), rt.get_loss("logistic")
    lmax = float(rt.lambda_max(ls, X, y))
    lmaxl = float(rt.lambda_max(lg, X, yl))
    for rule in ("saif", "gap_safe", "hybrid"):
        for ib in ("torch", "gram"):
            res = rt.saif(X, y, 0.1 * lmax, rt.SaifConfig(
                eps=1e-8, screen_rule=rule, inner_backend=ib), device="cpu")
            put(f"saif ls {rule} {ib}", res.beta, res.gap, res.n_outer,
                res.trace_gap)
        res = rt.saif(X, yl, 0.2 * lmaxl, rt.SaifConfig(
            eps=1e-8, screen_rule=rule, loss="logistic",
            inner_backend="torch"), device="cpu")
        put(f"saif lg {rule}", res.beta, res.gap, res.n_outer, res.trace_gap)
    Y = torch.stack([y, y * 0.5 + X[:, 20], y - X[:, 40]])
    lams = [0.3 * float(rt.lambda_max(ls, X, yy)) for yy in Y]
    for ib in ("torch", "gram"):
        fr = rt.fleet_solve(X, Y, lams, rt.SaifConfig(
            eps=1e-8, inner_backend=ib), device="cpu")
        put(f"fleet {ib}", fr.beta, fr.gap, fr.n_outer)
    W = torch.from_numpy((r.random((3, n)) < 0.7).astype(np.float64))
    fr = rt.fleet_solve(X, Y, lams, rt.SaifConfig(eps=1e-8), device="cpu",
                        weights=W)
    put("fleet weighted", fr.beta, fr.gap, fr.n_outer)
    put("path", *tensors(rt.saif_path(
        X, y, [0.5 * lmax, 0.3 * lmax, 0.1 * lmax],
        rt.SaifConfig(eps=1e-8), device="cpu")))
    put("dynamic", rt.dynamic_screening(
        X, y, 0.1 * lmax, rt.DynConfig(eps=1e-6), device="cpu").beta)
    put("sequential", *tensors(rt.sequential_path(
        X, y, [0.5 * lmax, 0.2 * lmax], device="cpu")))
    put("homotopy", *tensors(rt.homotopy_path(
        X, y, [0.5 * lmax, 0.2 * lmax], device="cpu")))
    put("cv", *tensors(rt.cv_solve(
        X, y, [0.5 * lmax, 0.2 * lmax, 0.1 * lmax], n_folds=3,
        config=rt.SaifConfig(eps=1e-8), device="cpu")))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", help="write the fingerprints here")
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    args = ap.parse_args()
    if args.compare:
        a, b = (json.load(open(f)) for f in args.compare)
        diff = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
        print(f"{len(a) - len(diff)} of {len(a)} equal; differing: {diff}")
        raise SystemExit(1 if diff else 0)
    fp = fingerprints()
    json.dump(fp, open(args.out, "w"), indent=1)
    print(f"{len(fp)} fingerprints")


if __name__ == "__main__":
    main()
