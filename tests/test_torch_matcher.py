"""The port's matcher facades (``repro_torch.core.matcher``) against the
JAX package's on one stream: Batch and Inc step for step equal, Adaptive
under the shared agent and seeded ``elapsed`` of ``test_torch_adaptive``
(store keys, counts and exact flags bitwise, goodness and TD losses within
1e-5 relative)."""

import numpy as np
import pytest
import torch

from repro.config.base import IGPMConfig as RCfg
from repro.core import matcher as rmatch
from repro.core.query import triangle as r_triangle
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.core import matcher as tmatch
from repro_torch.core.query import triangle as t_triangle
from test_torch_adaptive import (CPU, LOSS_RTOL, _cfg, _stores_equal,
                                 seeded_elapsed, share_agent,
                                 streams)  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["BatchMatcher", "NaiveIncrementalMatcher",
                                  "AdaptiveMatcher"])
def test_facades_match_reference(streams, name):
    ref_s, port_s = streams
    ref = getattr(rmatch, name)(r_triangle((0, 1, 2)), _cfg(RCfg))
    port = getattr(tmatch, name)(t_triangle((0, 1, 2)), _cfg(TCfg),
                                 device=CPU)
    if name == "AdaptiveMatcher":
        share_agent(ref.pem, port.pem)
        seeded_elapsed(ref.pem)
        seeded_elapsed(port.pem)
    g_r, g_p = ref_s.graph, port_s.graph
    for u_r, u_p in zip(ref_s.updates[:4], port_s.updates[:4]):
        g_r, a = ref.step(g_r, u_r)
        g_p, b = port.step(g_p, u_p)
        for f in ("step", "n_recompute", "n_new_patterns",
                  "n_patterns_total", "n_exact_total", "community_size",
                  "subgraph_nodes", "subgraph_edges", "n_pruned"):
            assert getattr(b, f) == getattr(a, f), f
        np.testing.assert_allclose(b.rl_loss, a.rl_loss, rtol=LOSS_RTOL)
    _stores_equal([ref.store], [port.store])
    assert port.store.total > 0
    assert (port.pem is None) == (name == "BatchMatcher")
    port.reset()
    assert port.step_idx == 0 and port.store.total == 0
