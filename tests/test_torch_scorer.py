"""The port's native CIDEr scorer (``fitness/scorer.py`` on
``csrc/ciderd.cpp``) against its pure-Python core and the JAX package's
``IndexedCiderScorer``, at the tolerance of ``tests/test_native_scorer.py``
(rtol 1e-6, atol 1e-9); the build's failure raises instead of falling back,
and the task's ``train_scorer`` against the JAX task's."""

import hashlib

import numpy as np
import pytest

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
from nes_img_captioning_tpu.fitness.scorer import (
    IndexedCiderScorer as JaxScorer,
)
from nes_img_captioning_tpu_torch.fitness import scorer as tscorer
from nes_img_captioning_tpu_torch.fitness.ciderd import CiderScorer
from nes_img_captioning_tpu_torch.fitness.scorer import IndexedCiderScorer

from torch_pin import one_intra_op_thread  # noqa: F401


def _corpus(rng, n_images=40, caps=5, T=16, vocab=40):
    gts = []
    for _ in range(n_images):
        rows = np.zeros((caps, T), np.int32)
        for c in range(caps):
            n = rng.integers(3, 10)
            rows[c, :n] = rng.integers(1, vocab + 1, size=n)
        gts.append(rows)
    return gts


def _cands(rng, gts, R=160):
    """Half (mutated) copies of a reference, half random captions."""
    img = rng.integers(0, len(gts), size=R)
    cands = np.zeros((R, 16), np.int32)
    for i in range(R):
        if i % 2 == 0:
            cands[i] = gts[img[i]][i % 5]
            if i % 4 == 0:
                cands[i, 1] = rng.integers(1, 41)
        else:
            n = rng.integers(2, 9)
            cands[i, :n] = rng.integers(1, 41, size=n)
    return cands, img


@pytest.mark.parametrize("frozen", [False, True], ids=["fitted", "frozen"])
@pytest.mark.parametrize("variant", ["cider-d", "cider"])
def test_native_matches_python_and_jax(variant, frozen):
    """Per-caption scores and the mean of the native core equal the Python
    core's and the JAX package's scorer's, with the DF fitted on the refs
    or frozen (a table fitted on another corpus, with its own ref_len)."""
    rng = np.random.default_rng(3)
    gts = _corpus(rng)
    table = None
    if frozen:
        other = _corpus(np.random.default_rng(11), n_images=25)
        table = (CiderScorer(variant=variant).fit_df(other).df,
                 float(np.log(40504.0)))
    nat = IndexedCiderScorer(gts, variant=variant, frozen_df=table)
    py = IndexedCiderScorer(gts, variant=variant, frozen_df=table,
                            prefer_native=False)
    jax_s = JaxScorer(gts, variant=variant, frozen_df=table)
    assert nat._native is not None and py._native is None
    cands, img = _cands(rng, gts)
    m_n, s_n = nat.score(cands, img)
    m_p, s_p = py.score(cands, img)
    m_j, s_j = jax_s.score(cands, img)
    assert np.ptp(s_n) > 0
    np.testing.assert_allclose(s_n, s_p, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(s_n, s_j, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(m_n, m_p, rtol=1e-6)
    np.testing.assert_allclose(m_n, m_j, rtol=1e-6)


def test_prefer_native_false_is_the_only_way_to_python():
    """The default scorer is native; prefer_native=False alone reaches the
    Python core, which then scores."""
    gts = _corpus(np.random.default_rng(0), n_images=5)
    nat = IndexedCiderScorer(gts, variant="cider")
    py = IndexedCiderScorer(gts, variant="cider", prefer_native=False)
    assert nat._native is not None and nat._py is None
    assert py._native is None and isinstance(py._py, CiderScorer)
    mean, scores = py.score(gts[0][:2], [0, 0])
    assert scores.shape == (2,) and mean > 0


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output,
    and the scorer does not fall back to Python."""
    bad = tmp_path / "ciderd.cpp"
    bad.write_text('extern "C" void* cider_new(int n) { return n; }\n'
                   "this is not C++;\n")
    monkeypatch.setattr(tscorer, "SOURCE", bad)
    gts = _corpus(np.random.default_rng(0), n_images=3)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed") as err:
        IndexedCiderScorer(gts)
    assert "error" in str(err.value)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        tscorer.build_native(bad)
    digest = hashlib.sha256(bad.read_bytes()).hexdigest()[:12]
    assert not list(tscorer._BUILD_DIR.glob(f"libciderd_{digest}*"))


def test_score_checks_its_inputs():
    gts = _corpus(np.random.default_rng(0), n_images=3)
    nat = IndexedCiderScorer(gts, variant="cider")
    with pytest.raises(ValueError, match="image index"):
        nat.score(gts[0][:1], [3])
    with pytest.raises(ValueError, match="candidates"):
        nat.score(gts[0][:2], [0])


def test_train_scorer_matches_jax(tmp_path):
    """CocoTask.train_scorer (CIDEr-D, DF over the train refs) of the port,
    on the native core, scores as the JAX task's."""
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JaxTask
    from nes_img_captioning_tpu.utils.config import Config as JaxConfig
    from nes_img_captioning_tpu.utils.config import TpuConfig as JaxTpu
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import Config, TpuConfig

    copts = make_synthetic_coco(str(tmp_path), n_train=12, n_val=4,
                                n_test=4, vocab_size=40, fc_feat_size=24,
                                cap_len=6, seed=0)
    exp = {"dataset": "mscoco", "caption_options": copts,
           "policy_options": {"fitness": "greedy", "vbn": False,
                              "model_options": {"input_encoding_size": 16,
                                                "rnn_size": 16,
                                                "fc_feat_size": 24}}}
    task = CocoTask(exp, Config(batch_size=4), TpuConfig(seed=0),
                    device="cpu")
    jtask = JaxTask(exp, JaxConfig(batch_size=4), JaxTpu(seed=0))
    rng = np.random.default_rng(5)
    img = rng.integers(0, 12, size=30)
    cands = np.stack([task.train_gts[i][k % 5] for k, i in enumerate(img)])
    cands[::3, 2] = rng.integers(1, 41, size=len(cands[::3]))
    m_t, s_t = task.train_scorer.score(cands, img)
    m_j, s_j = jtask.train_scorer.score(cands, img)
    assert task.train_scorer._native is not None
    np.testing.assert_allclose(s_t, s_j, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(m_t, m_j, rtol=1e-6)
