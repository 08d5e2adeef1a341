"""The partition layer across two processes: ``torch.distributed`` over
``gloo`` on ``localhost``, the processes started by
``torch.multiprocessing`` (``partition_cases.dist_worker``).

Each process joins the group through ``partition.ensure_distributed``
(``RAFT_TPU_COORDINATOR``, ``RAFT_TPU_NUM_PROCESSES``,
``RAFT_TPU_PROCESS_ID``), builds a ``("cases",)`` mesh of one CPU shard a
process and sweeps its half of an 8-case cylinder table (and of a
5-variant batch, padded to 6); the fixed point's stop flags are and-ed
over the processes and the lane table is assembled with ``all_gather``.
Both processes must end with the unsharded table: floats within
``partition_cases.ATOL``, ``iters``, ``converged``, ``fp_chunks`` and
the counted sweep pulls exactly the unsharded call's.
"""
import json
import socket

import numpy as np
import torch.multiprocessing as mp

from raft_tpu_torch.models import descent_cases as DC
from raft_tpu_torch.models import partition_cases as PC
from raft_tpu_torch.parallel.sweep import sweep_cases
from raft_tpu_torch.parallel.variants import sweep_variants


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_gather_the_unsharded_table(tmp_path):
    world = 2
    mp.start_processes(PC.dist_worker,
                       args=(world, _free_port(), str(tmp_path)),
                       nprocs=world, join=True, start_method="spawn")
    fowt = PC.cylinder("cpu")
    before = DC.pulls_by_what()
    ref = sweep_cases(fowt, *PC.cases(8), device="cpu", **PC.SWEEP_KW)
    ref_pulls = DC.pulls_between(before, DC.pulls_by_what())
    var = sweep_variants(fowt, PC.variant_thetas(len(fowt.members)),
                         device="cpu", **PC.VARIANT_KW)
    for rank in range(world):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        assert json.loads(str(got["facts"])) == {"process_index": rank,
                                                 "process_count": world}
        assert json.loads(str(got["mesh"]))["processes"] == world
        p = PC.parity({**got, "fp_chunks": int(got["fp_chunks"])}, ref,
                      PC.SWEEP_KEYS)
        assert PC.failures(p) == [], (rank, p)
        assert json.loads(str(got["pulls"])) == ref_pulls
        v = {k[4:]: got[k] for k in got if k.startswith("var_")}
        pv = PC.parity({**v, "fp_chunks": int(v["fp_chunks"])}, var,
                       PC.VARIANT_KEYS, rtol=PC.VARIANT_RTOL)
        assert PC.failures(pv) == [], (rank, pv)
