"""One env's cycles per team phase of the physics kernel (K1), in each of
its five variants, on one card.

    python3 scripts/torch_k1_clocks.py [--reps 20]
                                       [--out build/torch_k1_clocks.jsonl]

Builds the timing form of ``csrc/physics_step.cu`` (``RL_PHASE_CLOCKS``:
the first warp of block 0 notes ``clock64()`` at its start and at the end
of every team phase) and runs ``chip_smoke.py``'s kernel phases with it,
which hold each variant against its plain version. Then it launches each
variant ``--reps`` times on the grounded input that those phases last
launched at the main path's width (Go1 on the plane at 4096 envs, Mini
Cheetah over the default TerrainCfg mix at 4000, in the corridor at the
HLP's 1024) and prints one JSON line per variant: the median cycles of
each phase, summed over the phases of one name, and their total. The
lines also go to ``--out``, a path under the repo.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join("build",
                                                  "torch_k1_clocks.jsonl"))
    return ap.parse_args(argv)


def phase_labels(variant, nsub, depth):
    """The clocks' intervals in the order of substep_chain.cuh's phases
    (Chain::build_lists, then Chain::run), for a variant."""
    legacy = variant in ("legacy", "fixed_base")
    out = ["table and geom lists", "inputs"]
    for s in range(nsub):
        bias = [f"s{s} {w} ({kind})" for kind in ("free", "contact")
                for w in ("bias sweep", "base solve", "forward sweep")]
        out += [f"s{s} base + torques", f"s{s} FK", f"s{s} velocity bias"]
        out += [f"s{s} inertia sweep"] * 2 * depth + [f"s{s} base sum"]
        if not legacy:
            if s == 0:
                out += ["s0 Cholesky", "s0 Phi0 columns", "s0 Phi chains",
                        "s0 Phi blocks"]
            out += bias[:3] + [f"s{s} geom flags", f"s{s} contact counts"]
        out += [f"s{s} geom forces", f"s{s} body sums"] + bias[3:]
        out += [f"s{s} integrate"]
    return out + ["outputs"]


def variant_of(has_terrain, has_world, legacy, fixed_base):
    if fixed_base:
        return "fixed_base"
    if legacy:
        return "legacy"
    if has_world:
        return "world"
    return "terrain" if has_terrain else "plane"


def main(argv=None):
    import numpy as np
    import torch
    import chip_smoke as cs
    from rapid_locomotion_rl_tpu_torch.ops import cuda_physics as CP
    args = parse_args(argv)

    class Recorder(CP.PhysicsStepKernel):
        """The timing build, noting each variant's last launch per width."""

        def __init__(self):
            super().__init__(phase_clocks=True)
            self.last = {}

        def launch_packed(self, x, y, cst, layout, has_imp,
                          has_terrain=False, has_world=False, legacy=False,
                          fixed_base=False):
            flags = (has_terrain, has_world, legacy, fixed_base)
            self.last[(variant_of(*flags), x.shape[1])] = (
                x, cst, layout, (has_imp, *flags), y.shape[0])
            return super().launch_packed(x, y, cst, layout, has_imp, *flags)

    # the wrapper's physics_step_cuda and chip_smoke's phases launch
    # through the module's KERNEL
    CP.KERNEL = kernel = Recorder()
    dev = cs.phase_device()
    card = cs.card_line()
    cs.phase_build()
    cs.phase_kernel(dev)
    tc, grid = cs.mix_grid("terrain", dev)
    cs.phase_terrain(dev, tc, grid)
    cs.phase_world(dev, tc, grid, cs.N_HLP, "world")
    cs.phase_terrain(dev, tc, grid, "legacy", legacy=True)
    cs.phase_terrain(dev, tc, grid, "fixed-base", legacy=True,
                     fixed_base=True)
    widths = dict(plane=cs.N_ENVS, terrain=cs.N_MC, world=cs.N_HLP,
                  legacy=cs.N_MC, fixed_base=cs.N_MC)
    rows = []
    for name in cs.VARIANTS:
        x, cst, layout, flags, c_out = kernel.last[(name, widths[name])]
        y = torch.empty((c_out, x.shape[1]), device=dev)
        v = CP.variant_of(layout, *flags[1:])
        torch.cuda.synchronize()
        kernel.read_phase_clocks(v)
        runs = []
        for _ in range(args.reps):
            kernel.launch_packed(x, y, cst, layout, *flags)
            torch.cuda.synchronize()
            runs.append(np.diff(np.array(kernel.read_phase_clocks(v),
                                         np.int64)))
        d = np.median(np.stack(runs), 0)
        labels = phase_labels(name, int(cst[0].item()), layout.D)
        if len(labels) != len(d):
            labels = [f"phase {i}" for i in range(len(d))]
        phases = {}
        for lab, v in zip(labels, d.tolist()):
            phases[lab] = phases.get(lab, 0.0) + v
        row = dict(variant=name, n=x.shape[1], total_cycles=float(d.sum()),
                   card=card, phases=phases)
        print(json.dumps(row), flush=True)
        rows.append(row)
    out = os.path.join(ROOT, args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        for row in rows:
            fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
