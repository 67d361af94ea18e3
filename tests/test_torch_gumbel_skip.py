"""K3's exact skip of the Gumbel draw (``csrc/decode.cu``,
``member::SeedLane``), mirrored in float32 numpy over every uniform the 23
random bits of a word can give.

The kernel takes G = -log(-log u) by two accurate logf only where
``f32(1 - u) < f32(ex2.approx(f32(-t * log2 e)) * (1 + 2^-8))``, t =
f32(key - x) > 0 being how far the logit x trails its row's key (draw);
elsewhere the value cannot win and is skipped. The mirror lowers the
approximate exponential by 2^-21 (beyond the PTX ISA's 2 ulp) and raises
every G by one ulp beyond torch's f32 logs; wherever it skips, G must stay
at or below t, and x + G at or below the key. Two steps come before that
test: a count of words skipped on their bits alone (cut), and a key
borrowed from the lanes that hold the row's other columns (bound)."""

import numpy as np
import torch

from torch_pin import one_intra_op_thread  # noqa: F401

LOG2E = np.float32(1.44269504088896341)
SLACK = np.float32(1.00390625)  # 1 + 2^-8
SCALE = np.array([0x3F7FFFFD], np.uint32).view(np.float32)[0]  # f32(1 - 2e-7)
OFFSET = np.array([0x33D6BF95], np.uint32).view(np.float32)[0]  # f32(1e-7)
ONE = np.float32(1)


def _uniforms():
    """u of every 23-bit value, as gumbel_uniform computes it."""
    top = np.arange(1 << 23, dtype=np.uint32)
    unit = (top | np.uint32(0x3F800000)).view(np.float32) - ONE
    return unit * SCALE + OFFSET


def _threshold(t):
    """The lowest f32 e^-t (1 + eps) the card's test can form for t
    (f32): ex2.approx of the rounded argument, 2^-21 low."""
    with np.errstate(over="ignore"):  # t beyond 2^127: e = 0
        arg = np.float32(t) * -LOG2E
    e = np.float32(np.exp2(np.float64(arg)) * (1 - 2.0 ** -21))
    return e * SLACK


def _skipped_max():
    """(sorted f32(1 - u), suffix max of G + 1 ulp): the largest G among
    the values whose 1 - u is at least each threshold."""
    u = _uniforms()
    g = -torch.log(-torch.log(torch.from_numpy(u))).numpy()
    g = np.nextafter(g, np.float32(np.inf))  # one ulp of slack
    omu = ONE - u
    order = np.argsort(omu, kind="stable")
    gmax = np.maximum.accumulate(g[order][::-1])[::-1]
    return omu[order], gmax, u


def test_the_skip_never_drops_a_value_that_could_win():
    omu, gmax, u = _skipped_max()
    ts = np.unique(np.concatenate([
        np.geomspace(1e-7, 40.0, 6000), np.linspace(0.0, 20.0, 8001)[1:],
        [1e3, 1e9, 3e38, np.inf]]).astype(np.float32))

    def worst(t):  # the largest G the test skips at t (-inf: none)
        i = np.searchsorted(omu, _threshold(t), side="left")
        return gmax[i] if i < len(gmax) else -np.inf

    g_at = np.array([worst(t) for t in ts])
    assert (g_at <= ts).all(), ts[g_at > ts][:5]
    # the test is not vacuous: nearly every value skips far behind the key,
    # nearly none right behind it
    assert (omu >= _threshold(np.float32(6.0))).mean() > 0.99
    assert (omu >= _threshold(np.float32(1e-3))).mean() < 0.01
    # and in the kernel's terms, for logits around the key: f32(x + G) <=
    # key wherever t = f32(key - x) skips
    for x in np.float32([-30.0, -2.5, -0.37, 0.0, 0.61, 4.0, 17.0, 1e3]):
        for t in ts[(ts > 0) & (ts < 60)][::7]:
            key = np.float32(x + t)
            tk = np.float32(key - x)
            if tk > 0:
                assert np.float32(x + worst(tk)) <= key, (x, t)
    assert u.min() > 0 and u.max() < 1


def _cut(thr):
    """SeedLane::cut's count of 23-bit words skipped at threshold thr (f32
    array): floor(f32(f32(f32(1 - thr) - 1e-7) * 8388609)) - 8, at least
    0."""
    below = (ONE - thr) - OFFSET
    k = np.floor(below * np.float32(8388609.0)).astype(np.int64) - 8
    return np.maximum(k, 0)


def test_the_bits_cut_skips_only_values_the_test_would_skip():
    """Every word whose top 23 bits lie below cut(thr) passes draw's test
    f32(1 - u) >= thr, for thresholds over their whole range (0 to 1 + 2^-8
    and beyond, every 97th f32 and random ones); 1 - u falls as the bits
    rise, so checking the last word below the cut covers the rest. And the
    cut is no loose bound: it stays within 16 words of the exact count."""
    u = _uniforms()
    omu = ONE - u
    assert (np.diff(omu) <= 0).all()
    top = np.array([0x3F808000], np.uint32)[0]  # f32(1.0039)
    thr = np.arange(0, top, 97, dtype=np.uint32).view(np.float32)
    thr = np.concatenate([thr, np.random.default_rng(0).uniform(
        0, 1.01, 1 << 20).astype(np.float32), np.float32([0, 1, 1.01])])
    cut = _cut(thr)
    assert cut.max() < len(omu)
    ok = cut == 0
    ok[~ok] = omu[cut[~ok] - 1] >= thr[~ok]
    assert ok.all(), thr[~ok][:5]
    exact = np.searchsorted(-omu, -thr, side="right")  # words with omu >= thr
    assert (cut <= exact).all() and (exact - cut).max() <= 16
    assert (cut > 0).mean() > 0.9


def _below(key):
    """SeedLane::bound's margin: f32(key - max(f32(|key| 2^-22), 2^-126))."""
    key = np.float32(key)
    step = np.maximum(np.float32(abs(key)) * np.float32(2.0 ** -22),
                      np.float32(2.0 ** -126))
    return np.float32(key - step)


def test_a_borrowed_key_skips_only_values_strictly_below_it():
    """A skip against another lane's key (SeedLane::bound) must leave
    f32(x + G) strictly below that key, or a skipped column with a smaller
    index could have tied the winner: the bound is pulled below the key
    first, and then the skip's own guarantee (f32(x + G) <= bound) makes it
    strict, for keys from denormals to 2^100."""
    omu, gmax, _ = _skipped_max()

    def worst(t):
        i = np.searchsorted(omu, _threshold(t), side="left")
        return gmax[i] if i < len(gmax) else -np.inf

    mags = np.concatenate([[0.0, 1e-45, 1e-40, 2.0 ** -126, 1e-30],
                           np.geomspace(1e-6, 2.0 ** 100, 400)])
    keys = np.float32(np.concatenate([mags, -mags]))
    rng = np.random.default_rng(0)
    checked = 0
    for key in keys:
        k = _below(key)
        assert k < key
        # logits from just below the key to 20 below it, and far below
        for x in np.float32(np.concatenate([
                key - np.float32(rng.uniform(0, 20, 24)),
                [np.float32(key) - np.float32(abs(key)) * np.float32(1e-6)]])):
            t = np.float32(k - x)
            if t > 0:
                g = worst(t)
                if np.isfinite(g):
                    checked += 1
                    assert np.float32(x + g) < key, (key, x)
    assert checked > 5000
