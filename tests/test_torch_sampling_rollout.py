"""Port parity for ``CocoTask.rollout_dec`` under every fitness kind and
the vocab-tiled decode, against JAX's ``rollout_dec`` fed the same Gumbel
tables, at the toy size of ``test_torch_sampling.py``, whose tasks and
tables it uses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_sampling import (  # noqa: F401
    B,
    KINDS,
    _jax_tables,
    _jax_task,
    _port_task,
    coco,
)

from torch_pin import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("kind,tile", [(k, 0) for k in KINDS]
                         + [("greedy", 128), ("self_critical", 128)])
def test_rollout_dec_matches_jax(coco, kind, tile):
    """CocoTask.rollout_dec on two decode-ordered members, every fitness
    kind (and the tiled decode), against JAX rollout_dec fed the same Gumbel
    tables: fitness within 1e-5."""
    jtask = _jax_task(coco, kind, decode_vocab_tile=tile)
    ttask = _port_task(coco, kind, decode_vocab_tile=tile)
    jl, tl = jtask.decode_layout, ttask.decode_layout
    theta = np.asarray(jtask.generate_theta(jax.random.PRNGKey(6)))
    members = [theta, theta * 1.5]
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 12, size=(2, B)).astype(np.int32)
    keys = [jax.random.key(11), jax.random.key(12)]
    consts = jtask.device_consts()
    jfits = [float(jtask.rollout_dec(jl.to_dec(jnp.asarray(m)),
                                     jnp.asarray(i), key=k,
                                     consts=consts)["fitness"])
             for m, i, k in zip(members, idx, keys)]
    lanes = None
    if kind not in ("greedy",) and not kind.startswith("greedy_"):
        lanes = torch.from_numpy(np.stack([_jax_tables(jtask, k, B)
                                           for k in keys]))
    vec = torch.stack([tl.to_dec(torch.from_numpy(m.copy()))
                       for m in members])
    tfits = ttask.rollout_dec(vec, torch.from_numpy(idx), lanes=lanes)
    assert tfits.shape == (2,)
    np.testing.assert_allclose(tfits.numpy(), jfits, atol=1e-5)
    assert np.isfinite(jfits).all()
