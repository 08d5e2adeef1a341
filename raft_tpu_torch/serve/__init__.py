"""raft_tpu_torch.serve — the always-on sweep service, on the card.

The port of ``raft_tpu/serve``: bounded-queue admission control with
typed load shedding (:class:`raft_tpu_torch.errors.AdmissionRejected` and
Retry-After hints), a batching window over one warm batch runner
(:func:`raft_tpu_torch.parallel.sweep.make_batch_runner`: the model's
constants resident on the card between requests, K1 or K3 on every
batch), per-request deadlines enforced by an out-of-band watchdog,
per-error-class retry and backoff (:mod:`.retry`), and the service
degradation ladder ``full -> no_qtf -> coarse -> reject``.

Durability and repeats: the write-ahead request journal
(:mod:`.journal`, the JAX package's record format) and its mirror to
peer directories (:mod:`.replica`), ``SweepService.recover`` /
``SweepService.drain``, several models as named tenants
(:mod:`.tenancy`), and the content-addressed result store
(:mod:`.resultstore`) with single-flight coalescing and neighbour warm
starts.  The long-request lane serves design optimizations
(``submit_optimize``) and farms (``submit_farm``).

Entry points: :class:`SweepService` (embedded),
``Model.make_service``, and the HTTP front door
(:mod:`.http`; ``python -m raft_tpu_torch.serve serve --design NAME``).
Not ported yet (ROADMAP A10): the router, the fleet, the soaks and the
learned read tier.
"""
from raft_tpu_torch.serve.config import MODES, ServeConfig  # noqa: F401
from raft_tpu_torch.serve.journal import (  # noqa: F401
    RequestJournal, replay, request_digest,
)
from raft_tpu_torch.serve.replica import WalMirror  # noqa: F401
from raft_tpu_torch.serve.resultstore import ResultStore  # noqa: F401
from raft_tpu_torch.serve.retry import (  # noqa: F401
    DEFAULT_BUDGETS, TERMINAL, RetryPolicy,
)
from raft_tpu_torch.serve.service import (  # noqa: F401
    SweepResult, SweepService, Ticket,
)
from raft_tpu_torch.serve.tenancy import (  # noqa: F401
    DEFAULT_TENANT, Tenant, TenantRegistry,
)
from raft_tpu_torch.serve.watchdog import Watchdog  # noqa: F401
