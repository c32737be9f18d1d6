"""Regenerate the golden parity fixture (run from repo root).

Golden tensors are produced by the float64 NumPy oracle on a fixed seed;
tests/oracle/test_golden.py holds every compute path to them.  Regenerate
ONLY when the potential conventions deliberately change.
"""
import numpy as np

from asr_craft.ops import oracle


def main():
    rng = np.random.default_rng(20260817)
    B, T, L = 3, 14, 9
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    lengths = np.asarray([14, 8, 5], np.int32)

    alphas = np.zeros((B, T, L))
    betas = np.zeros((B, T, L))
    gammas = np.zeros((B, T, L))
    logZ = np.zeros(B)
    vit_paths = np.zeros((B, T), np.int32)
    vit_scores = np.zeros(B)
    for b in range(B):
        n = int(lengths[b])
        a, z = oracle.forward_np(state[b], trans, n)
        alphas[b, :n] = a
        betas[b, :n] = oracle.backward_np(state[b], trans, n)
        gammas[b, :n] = oracle.posteriors_np(state[b], trans, n)
        logZ[b] = z
        p, s = oracle.viterbi_np(state[b], trans, n)
        vit_paths[b, :n] = p
        vit_scores[b] = s

    Dmax = 4
    seg = rng.normal(size=(B, T, Dmax, L)).astype(np.float32)
    seg_logZ = np.zeros(B)
    for b in range(B):
        _, seg_logZ[b] = oracle.segmental_forward_np(
            seg[b], trans, int(lengths[b]), Dmax)

    np.savez_compressed(
        "tests/fixtures/golden_v1.npz",
        state=state, trans=trans, lengths=lengths, alphas=alphas,
        betas=betas, gammas=gammas, logZ=logZ, vit_paths=vit_paths,
        vit_scores=vit_scores, seg=seg, seg_logZ=seg_logZ)
    print("wrote tests/fixtures/golden_v1.npz")


if __name__ == "__main__":
    main()
