"""K1 inputs shared by the port's encoder tests on the CPU
(tests/test_torch_rans_enc.py) and on the card (tests/test_torch_cuda.py):
seeded numpy models in K1's [T, L] layout, as int32 freq and cum and bool
active tensors on the CPU."""
import numpy as np
import torch

M = 1 << 14


def _tensors(freq, cum, active):
    return (torch.from_numpy(freq.astype(np.int32)),
            torch.from_numpy(cum.astype(np.int32)), torch.from_numpy(active))


def enc_models(seed, t_steps, lanes, max_freq=4096):
    """Random models with every lane kind K1 must handle: inactive tails of
    each length (lane 0 all active, lane 1 all inactive), a lane that emits
    nothing (lane 2: f = 2^14 - 1, c = 0, so x grows by x / f a step, far
    from f << 18), one that emits at most steps (lane 3: f = 1); elsewhere
    freqs in [1, max_freq) with 30% at 1, cum in [0, 2^14 - f], and unused
    freqs up to 2^15 where inactive."""
    rng = np.random.default_rng(seed)
    freq = rng.integers(1, max_freq, (t_steps, lanes))
    freq[rng.random((t_steps, lanes)) < 0.3] = 1
    cum = (rng.random((t_steps, lanes)) * (M - freq + 1)).astype(np.int64)
    lengths = rng.integers(0, t_steps + 1, lanes)
    lengths[0] = t_steps
    if lanes > 1:
        lengths[1] = 0
    active = np.arange(t_steps)[:, None] < lengths[None, :]
    if lanes > 3:
        freq[:, 2], cum[:, 2] = M - 1, 0
        freq[:, 3] = 1
    freq[~active] = rng.integers(0, 1 << 15, int((~active).sum()))
    return _tensors(freq, cum, active)


def every_freq_models(seed, t_steps=640, lanes=33):
    """All-active models whose freqs take every value in [1, 2^14), the
    rest of the T * L steps random, shuffled; cum in [0, 2^14 - f], and
    lane 0 at the largest cum, 2^14 - f."""
    rng = np.random.default_rng(seed)
    f = np.concatenate([np.arange(1, M),
                        rng.integers(1, M, t_steps * lanes - M + 1)])
    freq = rng.permutation(f).reshape(t_steps, lanes)
    cum = (rng.random((t_steps, lanes)) * (M - freq + 1)).astype(np.int64)
    cum[:, 0] = M - freq[:, 0]
    return _tensors(freq, cum, np.ones((t_steps, lanes), bool))
