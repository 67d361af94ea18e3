"""NIC-ES children built in decode order (``tpu.es_decode_layout: true``)
in the port, after the JAX package's tests/test_es_layout.py, on the CPU at
toy size (vocab 40, E = R = 16, 24-d features; the JAX side decodes with
its fused kernel in interpret mode, the port with its kernels' plain twins,
both at f32).

torch cannot reproduce JAX's noise, so the port's ``ESEngine.normal_of``
is handed JAX's realized decode-ordered normals
(``jax.random.normal(key(seed), (dim_dec,))``)."""

import numpy as np
import pytest
import torch

from test_torch_es import (  # noqa: F401
    CALLS,
    PATHS,
    coco,
    es_exp,
    final_state,
    record,
    torch_master,
)

from torch_pin import one_intra_op_thread  # noqa: F401

KINDS = ["", "SM-PROPORTIONAL", "SM-G-SUM", "SM-VECTOR"]
SIGMA = 0.05


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    """The JAX task (fused decode forced, interpret mode) and the port's on
    the same synthetic data, as test_es_layout.py's ``coco_task``."""
    from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JTask
    from nes_img_captioning_tpu.utils.config import Config as JConfig
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    d = str(tmp_path_factory.mktemp("coco_es_layout"))
    copts = make_synthetic_coco(d, n_train=12, n_val=4, n_test=4,
                                vocab_size=40, fc_feat_size=24, cap_len=6,
                                seed=0)
    exp = {
        "dataset": "mscoco",
        "caption_options": copts,
        "policy_options": {"fitness": "greedy", "model_options": {
            "input_encoding_size": 16, "rnn_size": 16, "fc_feat_size": 24,
        }},
        "tpu": {"seed": 0, "fused_decode": True, "precision": "f32"},
    }
    jtask = JTask(exp, JConfig(batch_size=4), jp(exp))
    jtask._fused_interpret = True
    ttask = CocoTask(exp, Config(batch_size=4), parse_tpu_config(exp),
                     device="cpu")
    assert jtask.decode_layout is not None
    assert ttask.decode_layout is not None
    return jtask, ttask


def _engines(tasks, kind: str, **kw):
    """(JAX engine, port engine handed its normals), both on the layout."""
    import jax
    import jax.numpy as jnp

    from nes_img_captioning_tpu.algorithms.es import ESEngine as JEngine
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JKind
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    jtask, ttask = tasks
    jeng = JEngine(jtask, JKind(kind), pop_chunk=2, use_layout=True, **kw)
    eng = ESEngine(ttask, MutationKind(kind), pop_chunk=2, use_layout=True)
    assert jeng._layout is not None and eng._layout is not None
    n = eng._layout.dim_dec
    assert n == jeng._layout.dim_dec

    def normal_of(seed):
        key = jeng._mk_key(jnp.uint32(seed))
        return torch.from_numpy(np.asarray(jax.random.normal(
            key, (n,), jnp.float32)).copy())

    eng.normal_of = normal_of
    return jeng, eng


def _operands(dim: int, kind: str, seed: int, P: int = 3, L: int = 4):
    """Parents (P, dim), the JAX sensitivity matrix and the port's operand
    (SM-G: (P, dim) rows; SM-VECTOR: its (dim,) vector; else None), seeds,
    parent rows and a batch, from a numpy seed."""
    rng = np.random.default_rng(seed)
    parents = (rng.standard_normal((P, dim)) * 0.1).astype(np.float32)
    rows = P if kind == "SM-G-SUM" else 1
    sens = (1.0 + rng.random((rows, dim))).astype(np.float32)
    seeds = rng.integers(0, 2**32, size=L, dtype=np.uint32)
    pidx = rng.integers(0, P, size=L).astype(np.int32)
    port_sens = {"SM-G-SUM": torch.from_numpy(sens),
                 "SM-VECTOR": torch.from_numpy(sens[0])}.get(kind)
    return parents, sens, port_sens, seeds, pidx, np.arange(4,
                                                            dtype=np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_layout_sweep_matches_jax(tasks, kind):
    """Per-parent scale rows (SM-PROPORTIONAL, SM-G-SUM) and one shared row
    (plain, SM-VECTOR): the port's children, built in decode order from
    JAX's normals and mapped back by ``materialize``, within rtol 1e-6 of
    JAX's; its layout sweep's fitnesses within 1e-5 of JAX's (CIDEr-D
    summed in another order) and bit for bit a torch-order replay: the
    same decode-ordered children mapped back by ``from_dec`` and rolled
    out by ``CocoTask.rollout``."""
    import jax.numpy as jnp

    jtask, ttask = tasks
    jeng, eng = _engines(tasks, kind)
    parents, sens, port_sens, seeds, pidx, idx_row = _operands(
        eng.dim, kind, 3)
    jp, js = jnp.asarray(parents), jnp.asarray(sens)
    jfit = np.asarray(jeng.eval_generation(jp, js, SIGMA, seeds, pidx,
                                           idx_row)["fitness"])
    jmat = np.asarray(jeng.materialize(jp, js, SIGMA, seeds, pidx))

    tp = torch.from_numpy(parents)
    fit = eng.eval_generation(tp, SIGMA, seeds, pidx, idx_row,
                              sens=port_sens)["fitness"]
    mat = eng.materialize(tp, SIGMA, seeds, pidx, sens=port_sens)
    np.testing.assert_allclose(mat.numpy(), jmat, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fit.numpy(), jfit, rtol=0, atol=1e-5)
    assert np.isfinite(jfit).all()

    build = eng._child_ctx(tp, SIGMA, port_sens)[0]
    kids = build(seeds, torch.from_numpy(pidx.astype(np.int64)))
    replay = ttask.rollout(eng._layout.from_dec(kids),
                           torch.from_numpy(idx_row.astype(np.int64)))
    assert torch.equal(replay["fitness"], fit)


def test_layout_materialize_exact_roundtrip(tasks):
    """``materialize`` gives the sweep's decode-ordered children back in
    torch order, and ``to_dec`` of them is those children bit for bit,
    pads included (to_dec and from_dec are permutations). The sweep lays
    out the parents and the scale rows once, never an offspring: two
    ``to_dec`` calls for three chunks."""
    _, eng = _engines(tasks, "")
    lay = eng._layout
    parents, _, _, seeds, pidx, idx_row = _operands(eng.dim, "", 7, P=2,
                                                     L=6)
    tp = torch.from_numpy(parents)
    kids = eng._child_ctx(tp, SIGMA)[0](
        seeds, torch.from_numpy(pidx.astype(np.int64)))
    mat = eng.materialize(tp, SIGMA, seeds, pidx)
    assert torch.equal(lay.to_dec(mat), kids)
    assert torch.equal(mat, lay.from_dec(kids))
    for i in range(len(seeds)):
        assert torch.equal(lay.from_dec(kids[i]), mat[i])

    calls = []
    to_dec = lay.to_dec

    def counted(flat, pad_scale=1.0):
        calls.append(tuple(flat.shape))
        return to_dec(flat, pad_scale)

    lay.to_dec = counted
    try:
        eng.eval_generation(tp, SIGMA, seeds, pidx, idx_row)
    finally:
        del lay.to_dec
    assert calls == [(2, eng.dim), (1, eng.dim)]


@pytest.mark.parametrize("mutation", ["", "SM-G-SUM"])
def test_layout_paths_bitwise_equal(coco, tmp_path, mutation, monkeypatch):
    """With ``tpu.es_decode_layout: true``, the port's plain, fused and
    blocked paths from one tpu.seed, 6 generations: fitness vectors,
    children and podium rows and mean|policy| bit for bit, without a safe
    mutation and with SM-G-SUM (JAX: test_fused_es_layout_matches_plain_
    trajectory and test_es_layout_block_matches_per_generation hold these
    within 1e-4)."""
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    runs = {}
    for path, tpu in PATHS.items():
        exp = es_exp(coco, tmp_path / path, mutation=mutation,
                     es_decode_layout=True, **tpu)
        exp["policy_options"]["model_options"][
            "safe_mutation_underflow"] = 0.01
        m = torch_master(exp)
        assert m.engine._layout is not None
        log = record(m, ESEngine, monkeypatch)
        m.run_master(max_iterations=6)
        assert log["calls"] == CALLS[path]
        runs[path] = (log, final_state(m), m.stats.to_dict())
    plain = runs["plain"]
    assert np.ptp(np.concatenate(plain[0]["fitness"])) > 0
    for path in ("fused", "blocked"):
        log, (c, pod, n), st = runs[path]
        for a, b in zip(plain[0]["fitness"], log["fitness"]):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, plain[1][0])
        assert n == plain[1][2]
        for (_, ra), (_, rb) in zip(plain[1][1], pod):
            np.testing.assert_array_equal(rb, ra)
        assert st["norm_stats"] == plain[2]["norm_stats"]
    assert runs["fused"][2]["acc_stats"] == runs["blocked"][2]["acc_stats"]


@pytest.mark.parametrize("value,on", [(True, True), (False, False),
                                      ("auto", False), (1, False)])
def test_layout_knob_gating_matches_jax(tasks, value, on):
    """Only an explicit True opts into the layout, in both packages: the
    engine default, "auto" (the masters' default) and a truthy near-miss
    resolve to torch order (JAX: test_layout_knob_gating); the parsers
    refuse "false"."""
    from nes_img_captioning_tpu.algorithms.es import ESEngine as JEngine
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JKind
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.utils.config import parse_tpu_config

    jtask, ttask = tasks
    jeng = JEngine(jtask, JKind.DEFAULT, use_layout=value)
    eng = ESEngine(ttask, MutationKind.DEFAULT, use_layout=value)
    assert (jeng._layout is not None) is (eng._layout is not None) is on
    assert ESEngine(ttask, MutationKind.DEFAULT)._layout is None
    for parse in (jp, parse_tpu_config):
        assert parse({"tpu": {"es_decode_layout": "auto"}}
                     ).es_decode_layout is not True
        with pytest.raises(ValueError, match="es_decode_layout"):
            parse({"tpu": {"es_decode_layout": "false"}})
