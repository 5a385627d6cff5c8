"""The device mesh of the LM's distributed layers (PyTorch port of
``repro.launch.mesh``).

A :class:`Mesh` names its axes, gives each a size and lays a device list
over the positions in row-major order, as ``jax.make_mesh`` does. One
process drives every position (the JAX package is single-controller too):
a sharded tensor keeps one shard per position on that position's device,
and every collective is an explicit copy or sum in a fixed order
(``repro_torch.distrib``). A device list may repeat a device: the CPU
tests run ``["cpu"] * 4``, and ``["cuda:0"] * 4`` runs a 2 × 2 mesh on one
card, every shard at its real shape.

Each axis size must divide the production size of the axis with that name
(``distrib.sharding.AXIS_SIZE``: pod 2, data 16, model 16). The sharding
rules degrade a spec until every dimension divides its production shard
count, so on such a mesh no shard is uneven.

The single-controller steps do not run every position alike: each batch
shard's home position computes, a "model" position stores state (and, under
expert parallelism, runs its experts). So that a dry run
(``launch/dryrun.py``) can charge each op to the position doing it, the
sharded steps run each position's work inside ``Mesh.at(pos)``; an
autograd node that carries a tensor back across positions moves the
working position with it (``Mesh.shift``), so a backward pass is charged
where it runs. A collective's own copies run inside ``Mesh.moving()``:
their traffic is counted in ``Mesh.bytes``, not as the position's op
bytes. On a mesh of more than one position the dry run's tracker refuses
an op that runs outside every ``Mesh.at``. Outside a dry run the contexts
only push and pop.
A step whose one backward pass runs the work of several positions (the
GNNs' edge-sharded step) makes its forward inside
``Mesh.charge_backward()``: while a dry run tracks the mesh (``tracked``),
each autograd node made there runs its backward as the work of the
position that made it.
A meta device list (``["meta"] * 256``) lays the production mesh out with
nothing allocated.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.core.graph import canonical_device
from repro_torch.distrib.sharding import AXIS_SIZE


class Mesh:
    """``shape`` positions named by ``axis_names``, each on one device of
    ``devices`` (row-major). ``bytes`` counts what the collectives move
    between positions, by collective; ``received`` the bytes each position
    receives, where the collective names its receiver; ``moves`` the bytes
    by (collective, source, receiver), where it names both."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence):
        self.shape: Tuple[int, ...] = tuple(int(n) for n in shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} repeat a name")
        for name, n in zip(self.axis_names, self.shape):
            if name not in AXIS_SIZE:
                raise ValueError(f"mesh axis {name!r} is none of the "
                                 f"production axes {sorted(AXIS_SIZE)}")
            if n < 1 or AXIS_SIZE[name] % n:
                raise ValueError(
                    f"mesh axis {name!r} of size {n} does not divide its "
                    f"production size {AXIS_SIZE[name]}")
        self.devices: List[torch.device] = [canonical_device(d)
                                            for d in devices]
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"a {self.shape} mesh needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(self.devices)}")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1:
            raise ValueError(f"mesh devices of more than one type: "
                             f"{sorted(kinds)}")
        self.bytes: Dict[str, int] = collections.Counter()
        self.received: Dict[int, int] = collections.Counter()
        self.moves: Dict[Tuple[str, int, int], int] = collections.Counter()
        self._working: List[int] = []   # the working position, innermost last
        self._shifted: List[bool] = []  # whether ``shift`` set each entry
        self._moving = 0                # depth of nested collective copies
        self.tracked = False            # a dry run's tracker is counting

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in zip(self.axis_names,
                                                    self.shape))
        names = [str(d) for d in self.devices]
        if len(set(names)) == 1 and len(names) > 1:
            return f"Mesh({axes}; [{names[0]!r}] * {len(names)})"
        return f"Mesh({axes}; {names})"

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"{self!r} has no axis {name!r}")
        return self.shape[self.axis_names.index(name)]

    def coords(self, pos: int) -> Dict[str, int]:
        """Position ``pos`` (row-major) as {axis: coordinate}."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.shape)):
            out[name] = pos % n
            pos //= n
        return out

    def device(self, pos: int) -> torch.device:
        return self.devices[pos]

    @contextlib.contextmanager
    def at(self, pos: int) -> Iterator[None]:
        """Run the body as position ``pos``'s work."""
        self._working.append(int(pos))
        self._shifted.append(False)
        try:
            yield
        finally:
            self._working.pop()
            self._shifted.pop()

    @property
    def position(self) -> Optional[int]:
        """The position whose work runs now (``None`` outside every
        :meth:`at`)."""
        return self._working[-1] if self._working else None

    def shift(self, pos: int) -> None:
        """Make ``pos`` the working position until the innermost :meth:`at`
        ends: an autograd node calls it where its backward hands a gradient
        to another position, whose backward runs next."""
        if self._working:
            self._working[-1] = int(pos)
            self._shifted[-1] = True

    @property
    def shifted(self) -> bool:
        """Whether the working position is one an autograd node's ``shift``
        set (between the nodes of a backward pass, where the autograd
        engine's own sums and copies run), not one a :meth:`at` named."""
        return bool(self._shifted) and self._shifted[-1]

    @contextlib.contextmanager
    def charge_backward(self) -> Iterator[None]:
        """While ``tracked``: each autograd node an op in the body makes
        runs its backward as the work of the position working when it was
        made (a pre-hook moves the working position there). Otherwise the
        body runs as it is."""
        if not self.tracked:
            yield
            return
        with _NodePositions(self):
            yield

    @contextlib.contextmanager
    def moving(self) -> Iterator[None]:
        """Run the body as a collective's copies between positions."""
        self._moving += 1
        try:
            yield
        finally:
            self._moving -= 1

    @property
    def is_moving(self) -> bool:
        return self._moving > 0

    def count(self, collective: str, nbytes: int, to: Optional[int] = None,
              frm: Optional[int] = None) -> None:
        """Count ``nbytes`` moved by ``collective`` (from position ``frm``
        to position ``to``)."""
        self.bytes[collective] += int(nbytes)
        if to is not None:
            self.received[int(to)] += int(nbytes)
            if frm is not None:
                self.moves[(collective, int(frm), int(to))] += int(nbytes)

    def reset_bytes(self) -> None:
        self.bytes.clear()
        self.received.clear()
        self.moves.clear()


class _NodePositions(TorchFunctionMode):
    """Tags the autograd node of every op's outputs with the working
    position (:meth:`Mesh.charge_backward`), and every untagged node it
    reaches: an autograd function's node (a kernel's, whose ``apply`` this
    mode does not see) takes the position of the first op that reads its
    output, so its backward is charged where its forward ran."""

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh
        self._tagged = {}       # id → node, held so that no id is reused

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        pos = self.mesh.position
        if pos is None or not torch.is_grad_enabled():
            return out
        todo = [getattr(t, "grad_fn", None)
                for t in (out if isinstance(out, (tuple, list)) else (out,))]
        while todo:
            node = todo.pop()
            if node is None or id(node) in self._tagged:
                continue
            self._tagged[id(node)] = node
            if type(node).__name__ != "AccumulateGrad":
                node.register_prehook(
                    lambda grads, p=pos: self.mesh.shift(p))
            todo.extend(n for n, _ in node.next_functions)
        return out


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The reference's pod mesh: 16 × 16 (data, model), or 2 × 16 × 16
    (pod, data, model) with ``multi_pod``, over ``devices`` (a list may
    repeat a device; default: every visible card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(shape, axes, devices)


def make_host_mesh(device="cuda") -> Mesh:
    """The 1 × 1 mesh with the production axis names, on ``device``."""
    return Mesh((1, 1), ("data", "model"), [device])
