"""SASS instruction census of the mega kernel (the counterpart of
scripts/kernel_census.py).

The kernel is issue-bound (PERF.md §5): which instructions fill its issue
slots is what a speed-up of B1 / B1t has to change. `ncu` does not run on
the GPU machine, so this counts the machine code instead: `csrc/mega.cu`
built with the production flags plus `-lineinfo`, disassembled with
`nvdisasm`, every instruction of the flat kernel `hgt_mega_kernel<false>`
(B1; `--terrain`: `<true>`, B1t) by opcode and by its innermost line of
mega.cu / solve.cuh / apgd.cuh (humanoid_gym_tpu_torch/physics/sass_census.py).
Raises unless the count equals that of the same function in the
production library (`cuobjdump -sass` of the library the port loads).

The census is static: a loop body counts once. Beside it the script prints
the dynamic count by hand for one substep (`utils/roofline.py`
`mega_ops_executed(1, 8)`, or `mega_terrain_ops_executed`: float32
operations one warp executes, every lane counted).

Usage (needs the CUDA toolkit: nvcc, nvdisasm, cuobjdump):
    python scripts/kernel_census_torch.py [--terrain] [--lines 30] [--device cuda|cpu]
`--device cuda` (the default) raises without a card; the census itself
runs no kernel and needs only the toolkit. The last line is one JSON
object of the census.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def census(terrain: bool = False, lines: int = 30, opcodes: int = 12) -> dict:
    """The census of B1 (or B1t with `terrain`), checked against the
    production library's count, with the hand-counted dynamic operations of
    one substep beside it."""
    from humanoid_gym_tpu_torch.physics.sass_census import mega_census
    from humanoid_gym_tpu_torch.utils.roofline import (
        mega_ops_executed,
        mega_terrain_ops_executed,
    )

    both = mega_census(opcodes=opcodes, lines=lines)
    out = both["terrain" if terrain else "flat"]
    if out["instructions"] != out["production_instructions"]:
        raise RuntimeError(f"{out['function']}: {out['instructions']} instructions with -lineinfo, "
                           f"{out['production_instructions']} in the production library")
    executed = (mega_terrain_ops_executed if terrain else mega_ops_executed)(1, 8)
    out["dynamic_f32_ops_one_substep_by_hand"] = executed
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--terrain", action="store_true")
    p.add_argument("--lines", type=int, default=30)
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args(argv)

    from humanoid_gym_tpu_torch.utils.platform import resolve_device

    resolve_device(a.device)
    c = census(terrain=a.terrain, lines=a.lines)
    print(f"{c['function']}: {c['instructions']} SASS instructions (production library: "
          f"{c['production_instructions']}); {c['attributed_share'] * 100:.1f}% attributed to a line "
          f"of mega.cu / solve.cuh / apgd.cuh")
    print("per file: " + ", ".join(f"{f} {n}" for f, n in c["per_file"].items())
          + " | innermost (toolkit headers included): "
          + ", ".join(f"{f} {n}" for f, n in c["per_innermost_file"].items()))
    print("\ntop opcodes:")
    for k, v in c["top_opcodes"]:
        print(f"  {k:24s} {v}")
    print("\ntop source lines:")
    for k, v in c["top_lines"]:
        print(f"  {k:32s} {v}")
    print(f"\nstatic count (a loop body once): {c['instructions']}; dynamic by hand, one launch of "
          f"one substep at 8 iterations: {c['dynamic_f32_ops_one_substep_by_hand']:,} float32 "
          f"operations a warp, every lane counted "
          f"({c['dynamic_f32_ops_one_substep_by_hand'] // 32:,} warp instructions)")
    print(json.dumps(c), flush=True)
    return c


if __name__ == "__main__":
    main()
