"""A training run's curve beside the JAX flagship runs', against a band.

    python scripts/torch_curve.py runs/port_flagship_160
    python scripts/torch_curve.py runs/port_flagship_500 --band-at 500 \
        --min-tracking 9.0 --min-ep-len 450

Reads each run's metrics.jsonl (one row every 10 iterations, each the mean
over the iterations since the last row) and prints, at iterations
``AT``, ``train/episode/rew_tracking_lin_vel/mean``, ``ep_len_mean/mean``
and ``train/episode/command_area/mean`` of RUN and of the JAX runs
``JAX_RUNS``, the JAX runs' range at the band's iteration, and whether RUN
lies inside the band fixed before its run: tracking >= ``--min-tracking``
and episode length >= ``--min-ep-len`` at ``--band-at``. The defaults are
the early band of the 160-iteration runs (``BAND_AT``, ``MIN_TRACKING``,
``MIN_EP_LEN``); the 500-iteration run's band is in PERF.md §6.
Exits 1 when RUN is outside the band.
"""

import argparse
import json
import os
import sys

# the JAX package's 4000-env trimesh runs that walk
JAX_RUNS = ("r3_flagship", "r4_armA_minstd", "r4_armB_hull", "flagship4000",
            "flagship_r2", "validate1500", "ab_apparent600",
            "ab7_ent0_fixedphys2", "r5_flagship")
AT = (0, 50, 100, 150, 300, 500)
# the band: the JAX runs give 3.98-4.59 and 424-485 at iteration 150; the
# margin is for a different random stream
BAND_AT = 150
MIN_TRACKING = 3.0
MIN_EP_LEN = 350.0
TRACK = "train/episode/rew_tracking_lin_vel/mean"
EP_LEN = "ep_len_mean/mean"
AREA = "train/episode/command_area/mean"


def rows(run):
    """iteration -> metrics row of ``run``'s metrics.jsonl."""
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return {r["iterations"]: r for r in map(json.loads, f)
                if "iterations" in r}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run")
    ap.add_argument("--band-at", type=int, default=BAND_AT)
    ap.add_argument("--min-tracking", type=float, default=MIN_TRACKING)
    ap.add_argument("--min-ep-len", type=float, default=MIN_EP_LEN)
    args = ap.parse_args(argv)
    run, band_at = args.run, args.band_at
    refs = [os.path.join("runs", r) for r in JAX_RUNS]

    table = {run: rows(run)}
    table.update((r, rows(r)) for r in refs)
    print(f"{'run':22s} " + " ".join(f"{'it ' + str(i):>26s}" for i in AT))
    print(f"{'':22s} " + " ".join(f"{'track / ep_len / area':>26s}"
                                  for _ in AT))
    for name, rs in table.items():
        cells = []
        for i in AT:
            r = rs.get(i)
            cells.append("not logged".rjust(26) if r is None else
                         f"{r.get(TRACK, float('nan')):7.3f} / "
                         f"{r.get(EP_LEN, float('nan')):6.1f} / "
                         f"{r.get(AREA, float('nan')):7.4f}")
        print(f"{os.path.basename(name.rstrip('/')):22s} " + " ".join(cells))

    at_band = [table[r][band_at] for r in refs if band_at in table[r]]
    if at_band:
        print(f"references at {band_at}: {TRACK} "
              f"{min(r[TRACK] for r in at_band):.3f}-"
              f"{max(r[TRACK] for r in at_band):.3f}, {EP_LEN} "
              f"{min(r[EP_LEN] for r in at_band):.1f}-"
              f"{max(r[EP_LEN] for r in at_band):.1f}, {AREA} "
              f"{min(r[AREA] for r in at_band):.4f}-"
              f"{max(r[AREA] for r in at_band):.4f} ({len(at_band)} runs)")
    mine = table[run].get(band_at)
    inside = (mine is not None and mine[TRACK] >= args.min_tracking
              and mine[EP_LEN] >= args.min_ep_len)
    got = ("not logged" if mine is None else
           f"{mine[TRACK]:.3f} / {mine[EP_LEN]:.1f}")
    print(f"{run} at {band_at}: {got}; band {TRACK} >= {args.min_tracking}, "
          f"{EP_LEN} >= {args.min_ep_len}: "
          f"{'inside' if inside else 'OUTSIDE'}")
    return 0 if inside else 1


if __name__ == "__main__":
    sys.exit(main())
