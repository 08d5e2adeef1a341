"""The partition layer: named meshes over the batch axes.

Port of ``raft_tpu/parallel/partition.py`` (its batch axes; the frequency
axis is ROADMAP A9's next item).  A :class:`Mesh` names its axes and
holds one ``torch.device`` per position — ``("cases",)``, ``("variants",
"cases")``, ``("turbines", "cases")`` — and the batched entry points
(``sweep.sweep_cases``, ``sweep.sweep_farm``, ``variants.sweep_variants``,
``optimize.optimize_designs``) take it as ``mesh=``.  A device may repeat
(two shards on ``cpu``, or on ``cuda:0``), which stands in for the JAX
package's virtual CPU devices.

Axis vocabulary (the JAX package's)
-----------------------------------
``freq``
    The frequency-bin axis.  A mesh that has it is refused with
    :class:`~raft_tpu_torch.errors.PartitionRuleError` naming ROADMAP A9
    (`require_batch_only`): every drag pass reduces over frequency, so a
    frequency shard needs collectives inside the fixed point.
everything else (``cases``, ``variants``, ``turbines``, ``designs``)
    Batch axes.  The lane axis of a batch shards over the product of the
    batch axes, in mesh order (row-major over the device array).

Rules are written with the :data:`BATCH` / :data:`FREQ` placeholders and
matched by regex over each leaf's ``/``-joined path
(`match_partition_rules`), as in the JAX package; a spec is the port's
own :class:`Spec`, a tuple of axis tokens or ``None`` per dimension.

The sharded call (a single controller): `shard_tree` splits the padded
lane axis of every batch-spec'd leaf into one contiguous block per
shard, on that shard's device (a replicated leaf goes whole to every
shard); the entry point runs every shard's work before it waits on any
(work on different cards overlaps); the drag fixed point runs all the
shards as one (``sweep.unrolled_fixed_point`` over a list: one counted
pull a chunk over every shard's flags, and the global stop condition);
`gather_tree` puts the outputs on the first device in lane order.  The
entry point pads the batch to the mesh's batch size first (`pad_batch`,
copies of the last lane) and strips the padding (`unpad_batch`) before
any metric, manifest or result.

Multi-process: `ensure_distributed` initializes ``torch.distributed``
(``gloo`` on the CPU, ``nccl`` on the card) from ``RAFT_TPU_DIST`` /
``RAFT_TPU_COORDINATOR``, ``RAFT_TPU_NUM_PROCESSES`` and
``RAFT_TPU_PROCESS_ID``; `make_mesh` then lays the mesh over every
process's devices, process-major.  Every process holds the whole input;
each runs the shards it owns, the fixed point's stop flags are reduced
over the processes (`agree`, on a ``gloo`` group), and `gather_tree`
assembles the global lane table with ``all_gather``, so every process
ends with the same result.  ``torch.distributed`` is imported lazily:
importing the package opens no process group.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import re

import numpy as np
import torch
from torch.utils import _pytree as pytree

from raft_tpu_torch import errors

#: the one frequency-axis name (every other mesh axis is a batch axis)
FREQ_AXIS = "freq"

#: placeholder tokens used inside rule specs; resolved against the
#: concrete mesh by :func:`resolve_spec`
BATCH = "__batch__"
FREQ = "__freq__"

#: canonical mesh axis names
CANONICAL_AXES = ("variants", "cases", "turbines", FREQ_AXIS, "designs")


class Spec(tuple):
    """A partition spec: one axis token (a mesh axis name, a tuple of
    them, :data:`BATCH`, :data:`FREQ`) or ``None`` per dimension, leading
    dimensions first; missing trailing entries are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "Spec(" + ", ".join(map(repr, self)) + ")"


# ---------------------------------------------------------------------------
# pytree path naming
# ---------------------------------------------------------------------------

def _key_str(k) -> str:
    """One path component for any pytree key flavour."""
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def path_name(path) -> str:
    """``/``-joined leaf path name (``drag_pre/u_P``, ``pose/r6``)."""
    return "/".join(_key_str(k) for k in path)


def named_tree_map(fn, tree):
    """``tree_map`` handing ``fn(name, leaf)`` the ``/``-joined path name
    of every leaf."""
    return pytree.tree_map_with_path(
        lambda path, leaf: fn(path_name(path), leaf), tree)


# ---------------------------------------------------------------------------
# rule tables (the JAX package's)
# ---------------------------------------------------------------------------

#: the per-case / per-variant model state at the statics->dynamics
#: boundary (leading axis = the batch): the frequency stacks would also
#: shard their trailing axis over ``freq`` (kept for that axis to come)
STATE_RULES = (
    (r"(^|/)(M_lin|B_BEM)$", Spec(BATCH, None, None, FREQ)),
    (r"(^|/)F_lin$", Spec(BATCH, None, FREQ)),
    (r"(^|/)u0$", Spec(BATCH, None, None, FREQ)),
    (r"(^|/)drag_pre/(s_q|s_p1|s_p2)$", Spec(BATCH, None, FREQ)),
    (r"(^|/)drag_pre/u_P$", Spec(BATCH, None, None, FREQ)),
    (r".*", Spec(BATCH)),
)

#: sweep_cases inputs: (ncases,) scalars per case, batch-sharded
CASE_INPUT_RULES = (
    (r"^(Hs|Tp|beta)$", Spec(BATCH)),
)

#: sweep_variants inputs: every theta leaf carries a leading variant axis
VARIANT_INPUT_RULES = (
    (r".*", Spec(BATCH)),
)

#: sweep_farm inputs: the sea states as (L,) lanes, L = n_turbines *
#: ncases turbine-major, batch-sharded; the wake drivers are (ncases,)
#: per-case arrays of the wake equilibrium, replicated
FARM_INPUT_RULES = (
    (r"^(Hs|Tp|beta)$", Spec(BATCH)),
    (r"^(U_inf|wind_dir)$", Spec()),
)

#: per-case response state during the drag fixed point (batch, 6, nw)
XI_SPEC = Spec(BATCH, None, FREQ)


def _shape(leaf) -> tuple:
    return tuple(int(s) for s in (leaf.shape if hasattr(leaf, "shape")
                                  else np.shape(leaf)))


def match_partition_rules(rules, tree):
    """Pytree of (unresolved) specs for ``tree``: the first regex of
    ``rules`` that ``re.search``-matches a leaf's path name wins; 0-d and
    size-1 leaves are never partitioned.  A larger leaf no rule matches
    raises :class:`errors.PartitionRuleError`."""
    def get_spec(name, leaf):
        shape = _shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return Spec()
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                return spec
        raise errors.PartitionRuleError(
            f"no partition rule matches leaf '{name}' "
            f"(shape {shape}) — add a rule (or a catch-all) so every "
            "leaf's placement is deliberate", leaf=name, shape=shape)
    return named_tree_map(get_spec, tree)


def batch_axes(mesh) -> tuple:
    """Every mesh axis that is not the frequency axis, in mesh order."""
    return tuple(a for a in mesh.axis_names if a != FREQ_AXIS)


def batch_size(mesh) -> int:
    """Product of the batch-axis sizes (1 with no mesh) — the multiple
    the batch is padded to."""
    if mesh is None:
        return 1
    n = 1
    for a in batch_axes(mesh):
        n *= int(mesh.shape[a])
    return n


def resolve_spec(spec, mesh) -> Spec:
    """The concrete spec on ``mesh``: :data:`BATCH` becomes the tuple of
    batch axes (one name for one axis), :data:`FREQ` the frequency axis
    when the mesh has one; a placeholder whose axes the mesh lacks is
    ``None``; trailing ``None`` entries are dropped."""
    names = set(mesh.axis_names)
    out = []
    for entry in spec:
        if entry == BATCH:
            ax = batch_axes(mesh)
            out.append(ax if len(ax) > 1 else (ax[0] if ax else None))
        elif entry == FREQ:
            out.append(FREQ_AXIS if FREQ_AXIS in names else None)
        else:
            out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return Spec(*out)


# ---------------------------------------------------------------------------
# padded batches
# ---------------------------------------------------------------------------

def _repeat_last(x, npad):
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand((npad,) + tuple(x.shape[1:]))])
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], npad, axis=0)])


def pad_batch(tree, n: int, multiple: int):
    """Pad every leaf's leading batch axis from ``n`` to the next multiple
    of ``multiple`` by repeating the last row: padded lanes converge like
    the lane they copy (no fixed-point decision changes) and carry no
    NaN.  Returns ``(padded_tree, npad)`` (the tree itself when nothing
    pads); callers strip ``[:n]`` with `unpad_batch`."""
    npad = (-int(n)) % max(1, int(multiple))
    if npad == 0:
        return tree, 0
    return pytree.tree_map(lambda x: _repeat_last(x, npad), tree), npad


def unpad_batch(tree, n: int):
    """Strip the padded lanes (`pad_batch`'s inverse) from every leaf."""
    return pytree.tree_map(lambda x: x[:int(n)], tree)


# ---------------------------------------------------------------------------
# meshes, topology facts, fingerprints
# ---------------------------------------------------------------------------

def canonical_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card's
    ``cuda:N`` (so two spellings of one device compare equal)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Named axes over an array of devices.  ``devices`` has the mesh's
    shape (an object array of ``torch.device``), ``ranks`` the process
    that owns each position (all this process's on one process)."""

    def __init__(self, devices, axis_names, ranks=None):
        self.devices = devices
        self.axis_names = tuple(str(a) for a in axis_names)
        self.ranks = (np.full(devices.shape, process_index())
                      if ranks is None else ranks)

    @property
    def shape(self) -> dict:
        """Axis name -> size, in mesh order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return (f"Mesh({mesh_facts(self)['topology']}, "
                f"{[str(d) for d in self.devices.ravel()]})")


def make_mesh(shape=None, axes=None, devices=None) -> Mesh:
    """Named mesh over ``devices`` (default: every card of the process;
    a list may repeat a device).  ``shape`` / ``axes`` default to a 1-D
    ``("cases",)`` mesh over all of them.  Under ``torch.distributed``
    (`ensure_distributed`) ``devices`` are this process's, every process
    holds as many, and the mesh lays the processes' devices out
    process-major; the same call builds the same mesh on every process.
    A shape/axes mismatch or a mesh wanting more devices than there are
    raises :class:`errors.PartitionRuleError`."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [canonical_device(d) for d in devices]
    nproc = process_count()
    glob = [d for _ in range(nproc) for d in local]
    ranks = [r for r in range(nproc) for _ in local]
    if axes is None:
        axes = ("cases",)
    if shape is None:
        shape = (len(glob),)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axes)):
        raise errors.PartitionRuleError(
            f"mesh shape {shape} and axes {tuple(axes)} disagree",
            shape=shape, axes=tuple(axes))
    n = int(np.prod(shape))
    if n > len(glob):
        raise errors.PartitionRuleError(
            f"mesh shape {shape} wants {n} devices, {len(glob)} available",
            shape=shape, devices=len(glob))
    arr = np.empty(n, dtype=object)
    arr[:] = glob[:n]
    return Mesh(arr.reshape(shape), tuple(axes),
                np.asarray(ranks[:n]).reshape(shape))


def ambient_mesh(devices=None, device=None) -> Mesh | None:
    """Mesh described by ``RAFT_TPU_MESH`` (e.g. ``"cases=2"``,
    ``"variants=2,cases=2"``; a size left empty takes every device), or
    None when unset; ``devices`` as `make_mesh`'s.  ``device="cpu"``
    lays the mesh over the host, repeated (a CPU run's mesh)."""
    spec = os.environ.get("RAFT_TPU_MESH", "").strip()
    if not spec:
        return None
    axes, shape = [], []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if not name:
            continue
        axes.append(name)
        shape.append(int(size) if size.strip() else None)
    if not axes:
        return None
    if devices is None and device is not None \
            and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")] * int(np.prod([s or 1
                                                       for s in shape]))
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    shape = [len(devices) * process_count() if s is None else s
             for s in shape]
    return make_mesh(tuple(shape), tuple(axes), devices)


def require_batch_only(mesh, where: str):
    """Refuse a mesh with a ``freq`` axis (ROADMAP A9's next item) with a
    typed :class:`errors.PartitionRuleError`; anything else passes."""
    if mesh is not None and FREQ_AXIS in mesh.axis_names:
        raise errors.PartitionRuleError(
            f"{where}: a mesh with a '{FREQ_AXIS}' axis is not ported yet "
            "(ROADMAP A9: the frequency axis needs the drag pass's "
            "frequency reductions across devices); use batch axes only",
            where=where, topology=mesh_facts(mesh)["topology"])


def mesh_facts(mesh) -> dict | None:
    """JSON-able topology facts: ordered axis names and sizes, the device
    count, the topology string and the process span — what manifests and
    ledger configs record."""
    if mesh is None:
        return None
    return {
        "axes": list(mesh.axis_names),
        "shape": [int(mesh.shape[a]) for a in mesh.axis_names],
        "devices": int(mesh.size),
        "topology": "x".join(f"{a}={int(mesh.shape[a])}"
                             for a in mesh.axis_names),
        "processes": int(len(set(np.asarray(mesh.ranks).ravel().tolist()))),
    }


def mesh_key(mesh):
    """Hashable topology identity."""
    if mesh is None:
        return None
    return tuple((str(a), int(mesh.shape[a])) for a in mesh.axis_names)


def rules_fingerprint(*rule_tables) -> str:
    """Stable digest of one or more rule tables (pattern + spec pairs, or
    a single spec)."""
    h = hashlib.sha256()
    for rules in rule_tables:
        if isinstance(rules, Spec):
            rules = ((".*", rules),)
        for pattern, spec in rules:
            h.update(repr((pattern, tuple(spec))).encode())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# multi-process
# ---------------------------------------------------------------------------

def _dist():
    """``torch.distributed`` when a process group is open, else None."""
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    d = _dist()
    return int(d.get_rank()) if d is not None else 0


def process_count() -> int:
    d = _dist()
    return int(d.get_world_size()) if d is not None else 1


def process_facts() -> dict:
    return {"process_index": process_index(),
            "process_count": process_count()}


def ensure_distributed() -> dict:
    """Initialize ``torch.distributed`` for a multi-process run when
    configured; return the process facts either way.

    Opt-in: ``RAFT_TPU_COORDINATOR=host:port`` with
    ``RAFT_TPU_NUM_PROCESSES`` and ``RAFT_TPU_PROCESS_ID``, or
    ``RAFT_TPU_DIST=1`` with PyTorch's own ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.  The backend is ``nccl``
    with a card, ``gloo`` without.  A second call is a no-op, and a
    single-process run never initializes anything."""
    coord = os.environ.get("RAFT_TPU_COORDINATOR", "").strip()
    want = os.environ.get("RAFT_TPU_DIST", "").strip() in (
        "1", "on", "true") or coord
    if want and _dist() is None:
        import torch.distributed as dist

        backend = "nccl" if torch.cuda.is_available() else "gloo"
        try:
            if coord:
                dist.init_process_group(
                    backend, init_method=f"tcp://{coord}",
                    world_size=int(os.environ["RAFT_TPU_NUM_PROCESSES"]),
                    rank=int(os.environ["RAFT_TPU_PROCESS_ID"]))
            else:
                dist.init_process_group(backend, init_method="env://")
        except (RuntimeError, ValueError, KeyError) as e:
            raise errors.KernelFailure(
                f"torch.distributed.init_process_group failed: {e}",
                coordinator=coord or "env") from e
    return process_facts()


_CONTROL = {}


def _control_group():
    """A ``gloo`` group over every process, for host-side flags (the
    default group may be ``nccl``, which takes only card tensors)."""
    d = _dist()
    if d.get_backend() == "gloo":
        return None
    if "group" not in _CONTROL:
        _CONTROL["group"] = d.new_group(backend="gloo")
    return _CONTROL["group"]


#: the mesh of the sharded call in progress when it spans processes
_SPMD: list = []


@contextlib.contextmanager
def spmd(mesh):
    """Mark a sharded call over ``mesh``: while it runs, `agree` reduces
    its fixed points' stop flags over the mesh's processes (a no-op for
    a mesh of one process)."""
    multi = mesh is not None and mesh_facts(mesh)["processes"] > 1
    if multi:
        _SPMD.append(mesh)
    try:
        yield
    finally:
        if multi:
            _SPMD.pop()


def agree(flag: bool) -> bool:
    """``flag`` and-ed over the processes of the sharded call in progress
    (`spmd`); ``flag`` itself outside one."""
    if not _SPMD:
        return bool(flag)
    d = _dist()
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    d.all_reduce(t, op=d.ReduceOp.MIN, group=_control_group())
    return bool(int(t[0]))


# ---------------------------------------------------------------------------
# the sharded call: split, run, gather
# ---------------------------------------------------------------------------

def shards(mesh) -> list:
    """``(index, device, rank)`` of every shard of the lane axis, in lane
    order (row-major over the mesh's devices)."""
    require_batch_only(mesh, "sharded call")
    return [(i, d, int(r)) for i, (d, r) in enumerate(zip(
        mesh.devices.ravel(), np.asarray(mesh.ranks).ravel()))]


def local_shards(mesh) -> list:
    """The `shards` this process runs."""
    me = process_index()
    return [s for s in shards(mesh) if s[2] == me]


def shard_devices(mesh) -> list:
    """The device of each shard this process runs, in lane order."""
    return [d for _, d, _ in local_shards(mesh)]


def _block(x, i, n, device):
    """Block ``i`` of ``n`` equal contiguous blocks of ``x``'s leading
    axis, as a tensor on ``device``."""
    nl = x.shape[0]
    if nl % n:
        raise errors.PartitionRuleError(
            f"lane axis {nl} is not a multiple of the mesh's {n} shards "
            "(pad it with pad_batch first)", lanes=int(nl), shards=n)
    b = nl // n
    part = x[i * b:(i + 1) * b]
    if not isinstance(part, torch.Tensor):
        part = torch.as_tensor(np.ascontiguousarray(part))
    return part.to(device, non_blocking=True)


def _whole(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device, non_blocking=True)


def shard_tree(tree, mesh, rules) -> list:
    """One tree per shard this process runs, in lane order: a leaf whose
    matched rule's spec starts with :data:`BATCH` gives each shard its
    contiguous block of the leading axis, on the shard's device; any
    other leaf goes whole to every shard (replicated)."""
    specs = match_partition_rules(rules, tree)
    flat, spec_tree = pytree.tree_flatten(tree)
    sflat = pytree.tree_leaves(specs, is_leaf=lambda s: isinstance(s, Spec))
    n = mesh.size
    out = []
    for i, dev, _ in local_shards(mesh):
        leaves = [_block(x, i, n, dev) if (len(s) and s[0] == BATCH)
                  else _whole(x, dev) for x, s in zip(flat, sflat)]
        out.append(pytree.tree_unflatten(leaves, spec_tree))
    return out


def _wire(t):
    """A tensor ``all_gather`` takes on every backend, and its undo."""
    if t.is_complex():
        return torch.view_as_real(t).contiguous(), torch.view_as_complex
    if t.dtype == torch.bool:
        return t.to(torch.uint8), lambda u: u.to(torch.bool)
    return t.contiguous(), lambda u: u


def gather_tree(parts, mesh, device):
    """The trees of this process's shards (`shard_tree`'s order) joined
    along the lane axis on ``device``, in lane order; across processes
    the global table is assembled with ``all_gather`` (every process
    ends with it).  Non-tensor leaves are taken from the first part."""
    flats = [pytree.tree_flatten(p) for p in parts]
    spec_tree = flats[0][1]
    cols = list(zip(*[f[0] for f in flats]))
    d = _dist() if mesh_facts(mesh)["processes"] > 1 else None
    out = []
    for col in cols:
        if not isinstance(col[0], torch.Tensor):
            out.append(col[0])
            continue
        if d is None:
            out.append(torch.cat([c.to(device) for c in col]))
            continue
        wire_dev = device if d.get_backend() != "gloo" \
            else torch.device("cpu")
        local, undo = _wire(torch.cat([c.to(wire_dev) for c in col]))
        got = [torch.empty_like(local) for _ in range(process_count())]
        d.all_gather(got, local)
        out.append(undo(torch.cat(got)).to(device))
    return pytree.tree_unflatten(out, spec_tree)
