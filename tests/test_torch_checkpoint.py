"""Checkpoints and policy persistence of the port against the JAX package.

Directories written by either package's ``Engine.save`` restore into both,
and the two engines then serve on step for step equal (the adaptive PEM
under the shared agent and seeded ``elapsed`` of ``test_torch_adaptive``);
the port's files equal the reference writer's byte for byte (the index is
compared with ``msgpack``, which only this test imports); atomic commit,
the ignored ``.tmp``, keep-N and the async writer; the learned policy
carried across restarts in both directions; a ``control`` entry restored
as the reference restores it.
"""

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RCkpt
from repro.config.base import ControlConfig as RCtlCfg
from repro.config.base import EngineConfig as REngCfg
from repro.config.base import IGPMConfig as RCfg
from repro.config.base import ServingConfig as RServCfg
from repro.control import ServingController as RCtl
from repro.core.query import query_zoo as r_zoo
from repro.engine import Engine as REngine
from repro.runtime.runtime import AckLedger as RLedger
from repro.runtime.runtime import RuntimeKnobs as RKnobs
from repro.serving.server import MatchServer as RServer
from repro_torch.checkpoint import Checkpointer as TCkpt
from repro_torch.config.base import ControlConfig as TCtlCfg
from repro_torch.config.base import EngineConfig as TEngCfg
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.config.base import ServingConfig as TServCfg
from repro_torch.control import ACTION_NAMES
from repro_torch.control import ServingController as TCtl
from repro_torch.core.query import query_zoo as t_zoo
from repro_torch.engine import Engine as TEngine
from repro_torch.runtime.runtime import AckLedger as TLedger
from repro_torch.runtime.runtime import RuntimeKnobs as TKnobs
from repro_torch.serving.server import MatchServer as TServer
from test_torch_adaptive import (CPU, _cfg, _steps_equal, _stores_equal,
                                 seeded_elapsed, streams)  # noqa: F401

torch.set_num_threads(1)


def _engines(backend="coo"):
    ecfg = dict(mode="incremental", adaptive=True)
    ref = REngine(_cfg(RCfg, backend), REngCfg(**ecfg))
    port = TEngine(_cfg(TCfg, backend), TEngCfg(**ecfg), device=CPU)
    zoo_r = r_zoo(4) + [r_zoo(4)[0]._replace(name="dup")]
    zoo_t = t_zoo(4) + [t_zoo(4)[0]._replace(name="dup")]
    for q in zoo_r:
        ref.register(q)
    for q in zoo_t:
        port.register(q)
    return ref, port


def _serve(eng, state, updates):
    outs = []
    for u in updates:
        state, o = eng.step(state, u)
        outs.append(o)
    return state, outs


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(streams, tmp_path, writer):
    """One package serves 2 steps and saves; a fresh engine of EACH package
    loads the directory and both serve on, step for step equal."""
    ref_s, port_s = streams
    first_r, first_p = _engines()
    if writer == "reference":
        seeded_elapsed(first_r.pem, seed=9)
        s, _ = _serve(first_r, first_r.init_state(ref_s.graph),
                      ref_s.updates[:2])
        first_r.save(s, str(tmp_path))
    else:
        seeded_elapsed(first_p.pem, seed=9)
        s, _ = _serve(first_p, first_p.init_state(port_s.graph),
                      port_s.updates[:2])
        first_p.save(s, str(tmp_path))
    ref, port = _engines()
    s_r, step_r = ref.load(ref.init_state(ref_s.graph), str(tmp_path))
    s_p, step_p = port.load(port.init_state(port_s.graph), str(tmp_path))
    assert step_r == step_p == s_p.step_idx == 2
    assert port.pem.c == ref.pem.c
    assert port.pem.agent.t == ref.pem.agent.t
    _stores_equal([ref.stores[q] for q in ref.qids],
                  [port.stores[q] for q in port.qids])
    seeded_elapsed(ref.pem, seed=4)
    seeded_elapsed(port.pem, seed=4)
    s_r, o_r = _serve(ref, s_r, ref_s.updates[2:5])
    s_p, o_p = _serve(port, s_p, port_s.updates[2:5])
    _steps_equal(o_r, o_p)
    _stores_equal([ref.stores[q] for q in ref.qids],
                  [port.stores[q] for q in port.qids])


def test_checkpoint_files_equal_the_reference_writers(streams, tmp_path):
    """The port's index.msgpack bytes equal msgpack's, and the reference
    Checkpointer writes the same files for the same tree."""
    _, port_s = streams
    _, port = _engines()
    seeded_elapsed(port.pem)
    s, _ = _serve(port, port.init_state(port_s.graph), port_s.updates[:2])
    tree = port.state_dict(s)
    TCkpt(tmp_path / "t", async_save=False).save(2, tree)
    RCkpt(tmp_path / "r", async_save=False).save(2, tree)
    mine = (tmp_path / "t" / "step_000000000002" / "index.msgpack").read_bytes()
    theirs = (tmp_path / "r" / "step_000000000002" /
              "index.msgpack").read_bytes()
    assert mine == theirs
    assert msgpack.packb(msgpack.unpackb(mine)) == mine
    index = msgpack.unpackb(mine)
    assert any(leaf["key"] == "pem/agent/params/w0" for leaf in index["leaves"])
    with np.load(tmp_path / "t" / "step_000000000002" / "arrays.npz") as a, \
            np.load(tmp_path / "r" / "step_000000000002" / "arrays.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _tree():
    return {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "b": np.ones(3, np.int32), "nest": [np.zeros(2, bool),
                                                {"z": np.asarray(7, np.int64)}]}


def test_checkpoint_round_trip_atomic_commit_and_keep_n(tmp_path):
    ck = TCkpt(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree())
    assert ck.all_steps() == [3, 4]
    # a crash mid-save of step 5 leaves a .tmp directory behind
    (tmp_path / "step_000000000005.tmp").mkdir()
    assert ck.latest_step() == 4
    like = {"w": np.zeros((2, 3), np.float32), "b": np.zeros(3, np.int32),
            "nest": [np.ones(2, bool), {"z": np.asarray(0, np.int64)}]}
    back, step = ck.restore(like)
    assert step == 4
    np.testing.assert_array_equal(back["w"], _tree()["w"])
    assert back["b"].dtype == np.int32 and back["nest"][1]["z"] == 7
    assert list(back) == list(like)
    ck.save(4, {"w": np.zeros(1)})          # a committed step is not rewritten
    np.testing.assert_array_equal(ck.restore(like)[0]["w"], _tree()["w"])
    with pytest.raises(FileNotFoundError):
        TCkpt(tmp_path / "empty").restore(like)
    with pytest.raises(KeyError):
        ck.restore({"missing": np.zeros(1)})
    # float → int and bf16 follow the reference: the port's restore equals
    # the reference's on the same files, bitwise
    frac = {"w": np.asarray([[-2.75, -0.5, 0.5], [1.25, 2.99, 7.0]],
                            np.float32)}
    ck.save(8, frac)
    as_int = {"w": np.zeros((2, 3), np.int32)}
    got = ck.restore(as_int, step=8)[0]["w"]
    want = np.asarray(RCkpt(tmp_path).restore(as_int, step=8)[0]["w"])
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[-2, 0, 0], [1, 2, 7]])
    ck.save(9, {"p": torch.tensor([1.5, -3.0078125], dtype=torch.bfloat16)})
    got = ck.restore({"p": torch.zeros(2, dtype=torch.bfloat16)},
                     step=9)[0]["p"]
    want = RCkpt(tmp_path).restore(
        {"p": jnp.zeros(2, jnp.bfloat16)}, step=9)[0]["p"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def _bf16_tree(rng):
    """A bf16 leaf (values exact in bf16), an f32 one with fractions and an
    int32 one, from one numpy seed."""
    bits = (rng.standard_normal(64).astype(np.float32).view(np.uint32)
            & np.uint32(0xFFFF0000)).view(np.float32)
    return bits, rng.uniform(-9, 9, 16).astype(np.float32), \
        rng.integers(-50, 50, 8).astype(np.int32)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bf16_checkpoint_crosses_packages(tmp_path, writer):
    """A bf16 tree saved by either package (widened to f32 on disk)
    restores into the other bitwise after the cast back to bf16; the f32
    leaf restored as int32 truncates as the reference's cast does."""
    p, f, i = _bf16_tree(np.random.default_rng(5))
    if writer == "reference":
        RCkpt(tmp_path, async_save=False).save(
            3, {"p": jnp.asarray(p, jnp.bfloat16), "f": f, "i": i})
    else:
        TCkpt(tmp_path, async_save=False).save(
            3, {"p": torch.from_numpy(p).to(torch.bfloat16), "f": f, "i": i})
    with np.load(tmp_path / "step_000000000003" / "arrays.npz") as z:
        assert z["p"].dtype == np.float32     # widened on disk
        np.testing.assert_array_equal(z["p"], p)
    like_t = {"p": torch.zeros(64, dtype=torch.bfloat16),
              "f": np.zeros(16, np.int32), "i": np.zeros(8, np.int32)}
    like_r = {"p": jnp.zeros(64, jnp.bfloat16),
              "f": np.zeros(16, np.int32), "i": np.zeros(8, np.int32)}
    port, step_t = TCkpt(tmp_path).restore(like_t)
    ref, step_r = RCkpt(tmp_path).restore(like_r)
    assert step_t == step_r == 3
    assert port["p"].dtype == torch.bfloat16
    np.testing.assert_array_equal(port["p"].view(torch.int16).numpy(),
                                  np.asarray(ref["p"]).view(np.int16))
    np.testing.assert_array_equal(port["p"].float().numpy(), p)
    for k in ("f", "i"):
        assert port[k].dtype == np.int32
        np.testing.assert_array_equal(port[k], np.asarray(ref[k]))
    np.testing.assert_array_equal(port["f"], np.trunc(f).astype(np.int32))


def test_async_save_is_joined(tmp_path):
    ck = TCkpt(tmp_path, async_save=True)
    ck.save(5, _tree())
    ck.save(6, {"t": torch.arange(3)})
    ck.wait()
    assert ck.all_steps() == [5, 6]


def test_control_state_is_refused(streams, tmp_path):
    """A state carrying the serving controller's entry ('control') — as a
    tree and as a checkpoint directory of the reference — restores as the
    reference's engine restores it: unread when no controller is attached,
    into the attached controller otherwise (knob indices, counters, and
    Q-values within f32 rounding)."""
    ref, port = _engines()
    r_srv = RServer(_cfg(RCfg), r_zoo(2), RServCfg())
    r_ctl = RCtl(r_srv, RKnobs(r_srv), RLedger(), RCtlCfg(mode="train"))
    r_ctl.env.apply(ACTION_NAMES.index("window_down"))
    r_ctl.n_decisions, r_ctl.n_episodes = 3, 1
    ref.control = r_ctl
    tree = ref.state_dict(ref.init_state(streams[0].graph))
    RCkpt(tmp_path, async_save=False).save(0, tree)
    s_p = port.load_state_dict(tree)
    s_p, _ = port.load(port.init_state(streams[1].graph), str(tmp_path))
    assert s_p.step_idx == 0 and port.control is None
    probe = np.linspace(0.0, 1.0, 12, dtype=np.float32)
    for restore in ("tree", "directory"):
        t_srv = TServer(_cfg(TCfg), t_zoo(2), TServCfg(), device=CPU)
        t_ctl = TCtl(t_srv, TKnobs(t_srv), TLedger(), TCtlCfg(mode="train"))
        port.control = t_ctl
        if restore == "tree":
            port.load_state_dict(tree)
        else:
            port.load(port.init_state(streams[1].graph), str(tmp_path))
        assert t_ctl.env.knob_state() == r_ctl.env.knob_state()
        assert (t_ctl.n_decisions, t_ctl.n_episodes) == (3, 1)
        assert t_ctl.env.window_idx < len(t_ctl.env.window_ladder) - 1
        np.testing.assert_allclose(t_ctl.agent.q_values(probe),
                                   np.asarray(r_ctl.agent.q_values(probe)),
                                   rtol=1e-6, atol=1e-6)


# -- policy persistence ----------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_policy_persists_across_restarts(streams, tmp_path, writer):
    ref_s, port_s = streams
    if writer == "reference":
        first = RServer(_cfg(RCfg), r_zoo(2), RServCfg())
        first.run(ref_s.graph, ref_s.updates[:5])
    else:
        first = TServer(_cfg(TCfg), t_zoo(2), TServCfg(), device=CPU)
        first.run(port_s.graph, port_s.updates[:5])
    first.save_policy(str(tmp_path))
    want = first.policy_state()
    for restarted in (TServer(_cfg(TCfg), t_zoo(2), TServCfg(), device=CPU),
                      RServer(_cfg(RCfg), r_zoo(2), RServCfg())):
        assert restarted.load_policy(str(tmp_path)) == 5
        got = restarted.policy_state()
        assert int(got["community_size"]) == int(want["community_size"])
        for part in ("params", "target_params", "m", "v", "replay"):
            for k in want["agent"][part]:
                np.testing.assert_array_equal(got["agent"][part][k],
                                              want["agent"][part][k])
        assert int(got["agent"]["t"]) == int(want["agent"]["t"]) > 0
    inc = TServer(_cfg(TCfg), t_zoo(2), TServCfg(adaptive=False), device=CPU)
    with pytest.raises(ValueError, match="no policy"):
        inc.save_policy(str(tmp_path))


def test_server_save_load_round_trip(streams, tmp_path):
    _, port_s = streams
    a = TServer(_cfg(TCfg), t_zoo(4), TServCfg(), device=CPU)
    with pytest.raises(ValueError, match="before the first step"):
        a.save(str(tmp_path))
    g, _ = a.run(port_s.graph, port_s.updates[:3])
    a.save(str(tmp_path))
    b = TServer(_cfg(TCfg), t_zoo(4), TServCfg(), device=CPU)
    assert b.load(port_s.graph, str(tmp_path)) == 3
    for f in g._fields:
        assert torch.equal(getattr(b.graph, f), getattr(g, f)), f
    _stores_equal(a.stores, b.stores)
    assert b.pem.c == a.pem.c
    obs = np.array([[0.3, 0.2], [1.5, 0.9]], np.float32)
    np.testing.assert_array_equal(b.pem.agent.q_values(obs),
                                  a.pem.agent.q_values(obs))
