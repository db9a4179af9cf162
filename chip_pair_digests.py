"""Time verified:mean's kernels (#5, #8) of one checkout on one NVIDIA GPU.

    python3 chip_pair_digests.py CHECKOUT

CHECKOUT is the root of a checkout of this repository (``.`` for this one,
or an unpacked ``git archive`` of another commit). The script builds that
checkout's kernels, then holds and times #5 and #8 (int8, bf16) at the
full-width (4, d) stack through that checkout's own ``chip_smoke.py`` phase
2 cases, and #5 at a launch owner's (4, d/4) stack, as launch path (k)
calls it: within 1e-5 of the plain version, bitwise repeatable, the wire
kernels the bits of their float32 twin, the median of 5 calls timed with
CUDA events, one line each. A paired call runs it on the two sides in
turns (parent, change, change, parent) on one card, so that a commit whose
``chip_smoke.py`` has no owner-stack case for #5 is timed there too.
"""
import math
import os
import sys

import torch


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: chip_pair_digests.py CHECKOUT (needs a CUDA device)",
              file=sys.stderr)
        sys.exit(1)
    root = os.path.abspath(sys.argv[1])
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import centered_clip as kc

    build.compile_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = cs.stack(4, cs.D_FULL, gen, dev)
    stats, tag = {}, f"[{sys.argv[1]}]"
    for name, codec, kern, plain, nbytes, ops, moved, twin in (
            cs.digest_and_wire_cases(g, 4, 1.0, None, gen)):
        if name.startswith("mean_digest"):
            cs.hold(stats, f"{name} {codec}", f"{tag} {name} {codec}", kern,
                    plain, nbytes, ops, moved, True, twin)
    n, part = 4, cs.D_FULL // 4
    xs = g[:, :part].contiguous()
    z = torch.randn((1, part), generator=gen, device=dev)
    z = z / torch.linalg.vector_norm(z)
    nbytes = (n * part + 2 * part) * 4 + 2 * n * 4
    cs.hold(stats, "owner", f"{tag} mean_digest_fused owner stack n={n} "
            f"part={part}", lambda: kc.mean_digest_fused(xs, 1, z),
            lambda: kc.mean_digest_fused_plain(xs, 1, z), nbytes,
            n * part * 7, nbytes, True)
    print(cs.nvidia_smi_line())
    assert all(math.isfinite(st["ms"]) for st in stats.values())


if __name__ == "__main__":
    main()
