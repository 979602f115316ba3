"""Prints how far a decode lands from the jitted reference's when its
keys were rotated by the other RoPE frequency law: ``1 / theta ** e`` in
f32 ops (the eager reference's, ``layers.rope_frequencies(folded=
False)``) against the folded ``theta ** -e`` rounded once that every
jitted program of the reference takes, and that the port now takes on
every path; a prefill on the first law followed by a decode on the second
makes this gap. A measurement for ROADMAP queue C, not a test; on the
CPU:

    PYTHONPATH=src python tests/rope_laws.py [--seed 0]

At gemma2-2b's attention shape (8 query heads over 4 KV heads of 256,
theta 10,000, attention softcap 50) one decode query at position ``p``
attends to the keys of the positions before it: all 32,768 at
``decode_32k``'s last position 32,767, and the 8,192 of
``long_500k``'s window at 524,287. The keys are rotated by the unfolded
law and by the folded law (the jitted reference, whose prefill and
decode take one law); the query by the folded law. Printed:
the largest rotation-angle difference over the keys, the logits' largest
difference, and the attention output's L2 error relative to its norm.
The values are N(0, 1) from ``--seed``; no model weights."""
import argparse

import numpy as np
import torch

from repro_torch.models.layers import apply_rope, rope_frequencies, softcap

HEADS, KV_HEADS, HEAD_DIM, THETA, CAP = 8, 4, 256, 10000.0, 50.0
CASES = (("decode_32k", 32767, 32768), ("long_500k", 524287, 8192))


def decode_gap(pos: int, keys: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    q, k, v = t(1, 1, HEADS, HEAD_DIM), t(1, keys, KV_HEADS, HEAD_DIM), t(
        1, keys, KV_HEADS, HEAD_DIM)
    kpos = torch.arange(pos - keys + 1, pos + 1, dtype=torch.int32)
    qr = apply_rope(q, torch.tensor([pos], dtype=torch.int32), THETA, True)
    out, logits = {}, {}
    for folded in (False, True):
        kr = apply_rope(k, kpos, THETA, folded)
        kx = kr.repeat_interleave(HEADS // KV_HEADS, dim=2)
        vx = v.repeat_interleave(HEADS // KV_HEADS, dim=2)
        lg = softcap(torch.einsum("bqhd,bshd->bhqs", qr, kx)
                     / HEAD_DIM ** 0.5, CAP)
        logits[folded] = lg
        out[folded] = torch.einsum("bhqs,bshd->bqhd", torch.softmax(lg, -1),
                                   vx)
    f_a = rope_frequencies(HEAD_DIM, THETA, folded=False).double()
    f_b = rope_frequencies(HEAD_DIM, THETA, folded=True).double()
    angle = float((kpos.double()[:, None] * (f_a - f_b)).abs().max())
    return {"angle_rad": angle,
            "frequencies_differing": int((f_a != f_b).sum()),
            "logit_abs": float((logits[False] - logits[True]).abs().max()),
            "out_l2_rel": float(torch.linalg.vector_norm(
                out[False] - out[True]) / torch.linalg.vector_norm(
                    out[True]))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for name, pos, keys in CASES:
        r = decode_gap(pos, keys, args.seed)
        print(f"{name}: query at {pos} over {keys} keys: angle "
              f"{r['angle_rad']:.3e} rad ({r['frequencies_differing']} of "
              f"{HEAD_DIM // 2} frequencies differ), logits "
              f"{r['logit_abs']:.3e}, output L2 {r['out_l2_rel']:.3e}")


if __name__ == "__main__":
    main()
