"""Adam and L-BFGS with the zoom linesearch, batched over a lane axis.

The port's own copies of the two optimizers the JAX package's batched
descent takes from optax 0.2.6 (``raft_tpu/parallel/optimize.py:
_make_optimizer``): ``optax.adam(lr)`` and ``optax.lbfgs(memory_size=8,
linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=8))``.
Nothing of optax is imported (it imports JAX).

Every tensor has the lane axis first: X, G (lanes, P), a value (lanes,).
An optimizer is ``init(X) -> state`` and ``update(G, state, X, value=,
value_and_grad_fn=, frozen=) -> (updates, state)``; the state is a dict
of tensors, each with the lane axis first, so a caller can freeze lanes
with ``torch.where`` and keep the state as it is.  The arithmetic
follows optax's op for op (the moment updates, the bias correction with
``b ** count`` in float64, the two-loop recursion, the linesearch's
interpolations), so float64 iterates agree with optax's to the last bits
or close to them.

The linesearch runs every lane together, as ``jax.vmap`` runs optax's
``while_loop``: each iteration evaluates ``value_and_grad_fn`` once on
all lanes (a lane that is not searching any more is evaluated at its
current point and keeps its state), and the loop ends when no lane is
searching; that test is one counted host pull (``what=
"lbfgs_linesearch"``) per iteration.  Trial points are ``x + eta d``,
not clipped.  Lanes marked ``frozen`` (a caller that discards their
update: the descent's converged and non-finite lanes) start the search
done, so a NaN lane, whose search would run to the cap, does not hold
the batch for 8 iterations; every other lane's arithmetic is its own,
so its result is the same bit for bit.
"""
from __future__ import annotations

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.obs import transfers

_INT32_MAX = 2 ** 31 - 1

#: optax.adam's defaults
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
#: optax.scale_by_zoom_linesearch's defaults (its tol, increase_factor,
#: slope_rtol, curv_rtol, approx_dec_rtol, stepsize_precision)
LS_TOL, LS_INCREASE = 0.0, 2.0
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
INTERVAL_THRESHOLD = 1e-5


def _safe_increment(count):
    """``optax.safe_increment``: count + 1, stuck at the dtype's max."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _dot(a, b):
    """Per-lane inner product over the last axis (real)."""
    return torch.sum(a * b, dim=-1)


def _col(t):
    """(lanes,) -> (lanes, 1), to scale a (lanes, P) tensor."""
    return t[:, None]


class Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, no
    Nesterov.  State ``count`` (lanes,) int32, ``mu``, ``nu`` (lanes, P)."""

    def __init__(self, lr: float):
        self.lr = float(lr)

    def init(self, X) -> dict:
        return {"count": torch.zeros(X.shape[0], dtype=torch.int32,
                                     device=X.device),
                "mu": torch.zeros_like(X), "nu": torch.zeros_like(X)}

    def update(self, G, state, X=None, value=None, value_and_grad_fn=None,
               frozen=None):
        mu = (1 - B1) * G + B1 * state["mu"]
        nu = (1 - B2) * (G * G) + B2 * state["nu"]
        count = _safe_increment(state["count"])
        c = count.to(G.dtype)
        mu_hat = mu / _col(1.0 - torch.pow(B1, c))
        nu_hat = nu / _col(1.0 - torch.pow(B2, c))
        upd = mu_hat / (torch.sqrt(nu_hat + EPS_ROOT) + EPS)
        return (-self.lr) * upd, {"count": count, "mu": mu, "nu": nu}


class LBFGS:
    """``optax.lbfgs(memory_size, linesearch=scale_by_zoom_linesearch(
    max_linesearch_steps))`` with optax's other defaults: the scaled
    initial preconditioner (the first step capped at unit norm), no
    learning rate (scale -1), the zoom linesearch with
    ``initial_guess_strategy="keep"`` (the last step size seeds the next
    search), no maximal step, tol 0, increase factor 2, slope_rtol 1e-4,
    curv_rtol 0.9, approx_dec_rtol 1e-6, interval threshold 1e-5.

    State: ``count`` (int32), ``params``, ``updates``,
    ``diff_params_memory``, ``diff_updates_memory`` (lanes, m, P),
    ``weights_memory`` (lanes, m); the linesearch's ``learning_rate``,
    ``value``, ``grad``, ``num_linesearch_steps`` (int64),
    ``decrease_error``, ``curvature_error``."""

    def __init__(self, memory_size: int = 8, max_linesearch_steps: int = 8):
        self.m = int(memory_size)
        self.max_steps = int(max_linesearch_steps)

    def init(self, X) -> dict:
        L, P = X.shape
        z = torch.zeros(L, dtype=X.dtype, device=X.device)
        return {"count": torch.zeros(L, dtype=torch.int32, device=X.device),
                "params": torch.zeros_like(X),
                "updates": torch.zeros_like(X),
                "diff_params_memory": X.new_zeros((L, self.m, P)),
                "diff_updates_memory": X.new_zeros((L, self.m, P)),
                "weights_memory": X.new_zeros((L, self.m)),
                "learning_rate": z + 1.0, "value": z + float("inf"),
                "grad": torch.zeros_like(X),
                "num_linesearch_steps": torch.zeros(
                    L, dtype=torch.int64, device=X.device),
                "decrease_error": z + float("inf"),
                "curvature_error": z + float("inf")}

    # -- the L-BFGS direction (optax scale_by_lbfgs) ----------------------

    def _direction(self, G, state, X):
        m, count = self.m, state["count"]
        L = X.shape[0]
        lanes = torch.arange(L, device=X.device)
        memory_idx = torch.remainder(count, m).long()
        prev_idx = torch.remainder(count - 1, m).long()
        first = _col(count > 0)
        dp = X - state["params"]
        du = G - state["updates"]
        vd = _dot(du, dp)
        weight = torch.where(vd == 0.0, 0.0, 1.0 / vd)
        dp = torch.where(first, dp, 0.0)
        du = torch.where(first, du, 0.0)
        weight = torch.where(count > 0, weight, 0.0)
        slot = torch.arange(m, device=X.device)[None, :] == prev_idx[:, None]
        dw_mem = torch.where(slot[..., None], dp[:, None, :],
                             state["diff_params_memory"])
        du_mem = torch.where(slot[..., None], du[:, None, :],
                             state["diff_updates_memory"])
        rho = torch.where(slot, weight[:, None], state["weights_memory"])
        num = _dot(du, dp)
        den = torch.sum(du * du, dim=-1)
        scale = torch.where(den > 0.0, num / den, 1.0)
        capped = torch.clamp(1.0 / torch.sqrt(torch.sum(G * G, dim=-1)),
                             max=1.0)
        scale = torch.where(count > 0, scale, capped)
        # the two-loop recursion: newest pair back to the oldest, then on
        # from the oldest (slot memory_idx is the oldest)
        idx = torch.remainder(memory_idx[:, None]
                              + torch.arange(m, device=X.device)[None, :], m)
        vec, alphas = G, [None] * m
        for j in reversed(range(m)):
            i = idx[:, j]
            alphas[j] = rho[lanes, i] * _dot(dw_mem[lanes, i], vec)
            vec = vec + _col(-alphas[j]) * du_mem[lanes, i]
        vec = _col(scale) * vec
        for j in range(m):
            i = idx[:, j]
            beta = rho[lanes, i] * _dot(du_mem[lanes, i], vec)
            vec = vec + _col(alphas[j] - beta) * dw_mem[lanes, i]
        new = {"count": _safe_increment(count), "params": X, "updates": G,
               "diff_params_memory": dw_mem, "diff_updates_memory": du_mem,
               "weights_memory": rho}
        return -1.0 * vec, new

    # -- the zoom linesearch (optax zoom_linesearch) -----------------------

    @staticmethod
    def _decrease_error(t, v, s, v0, s0):
        err = v - v0 - SLOPE_RTOL * t * s0
        approx = s - (2 * SLOPE_RTOL - 1.0) * s0
        delta = v - v0 - APPROX_DEC_RTOL * torch.abs(v0)
        err = torch.minimum(torch.maximum(approx, delta), err)
        err = torch.clamp(err, min=0.0)
        return torch.where(torch.isnan(err), float("inf"), err)

    @staticmethod
    def _curvature_error(s, s0):
        err = torch.clamp(torch.abs(s) - CURV_RTOL * torch.abs(s0), min=0.0)
        return torch.where(torch.isnan(err), float("inf"), err)

    @staticmethod
    def _cubicmin(a, fa, fpa, b, fb, c, fc):
        C = fpa
        db = b - a
        dc = c - a
        dbc = db * dc
        denom = dbc * dbc * (db - dc)
        r0 = fb - fa - C * db
        r1 = fc - fa - C * dc
        A = (dc * dc * r0 + -(db * db) * r1) / denom
        B = (-(dc * (dc * dc)) * r0 + db * (db * db) * r1) / denom
        radical = B * B - 3.0 * A * C
        return a + (-B + torch.sqrt(radical)) / (3.0 * A)

    @staticmethod
    def _quadmin(a, fa, fpa, b, fb):
        db = b - a
        B = (fb - fa - fpa * db) / (db * db)
        return a - fpa / (2.0 * B)

    def _linesearch(self, d, X, value, grad, guess, value_and_grad_fn,
                    frozen=None):
        """The zoom linesearch of every lane along d (lanes, P) from X,
        the ``frozen`` lanes (lanes,) bool excepted; returns its final
        state (``stepsize``, ``value``, ``grad``, ``count``, the errors)."""
        where = torch.where
        slope = _dot(d, grad)
        zero = torch.zeros_like(value)
        false = torch.zeros_like(value, dtype=torch.bool)
        inf = zero + float("inf")
        s = {"count": torch.zeros_like(value, dtype=torch.int64),
             "stepsize": zero, "value": value, "grad": grad, "slope": slope,
             "decrease_error": inf, "curvature_error": inf, "error": inf,
             "interval_found": false,
             "done": false if frozen is None else frozen.clone(),
             "failed": false,
             "low": zero, "value_low": value, "slope_low": slope,
             "high": zero, "value_high": value, "slope_high": slope,
             "cubic_ref": zero, "value_cubic_ref": value,
             "safe_stepsize": zero, "safe_value": value, "safe_grad": grad}
        v0, s0, tol = value, slope, LS_TOL
        while True:
            active = ~(s["done"] | s["failed"])
            if not bool(transfers.device_get(torch.any(active),
                                             what="lbfgs_linesearch")):
                return s
            it = s["count"]
            # the search phase's trial step
            t_search = where(it == 0, guess, LS_INCREASE * s["stepsize"])
            # the zoom phase's: cubic, else quadratic, else bisection
            low, high = s["low"], s["high"]
            delta = torch.abs(high - low)
            left, right = torch.minimum(high, low), torch.maximum(high, low)
            mc = self._cubicmin(low, s["value_low"], s["slope_low"], high,
                                s["value_high"], s["cubic_ref"],
                                s["value_cubic_ref"])
            use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
            mq = self._quadmin(low, s["value_low"], s["slope_low"], high,
                               s["value_high"])
            use_quad = ~use_cubic & ((mq > left + 0.1 * delta)
                                     & (mq < right - 0.1 * delta))
            use_bis = ~use_cubic & ~use_quad
            middle = where(use_cubic, mc, s["cubic_ref"])
            middle = where(use_quad, mq, middle)
            middle = where(use_bis, (low + high) / 2.0, middle)
            zoom = s["interval_found"]
            t = where(active, where(zoom, middle, t_search), 0.0)
            vt, gt = value_and_grad_fn(X + _col(t) * d)
            st = _dot(gt, d)
            dec = self._decrease_error(t, vt, st, v0, s0)
            curv = self._curvature_error(st, s0)
            err = torch.maximum(dec, curv)
            safe = dec <= tol
            n = dict(s, count=it + 1, stepsize=t, value=vt, grad=gt, slope=st,
                     decrease_error=dec, curvature_error=curv, error=err,
                     done=err <= tol)
            # search phase (Nocedal & Wright, Algorithm 3.5)
            high_new = (dec > 0.0) | ((vt >= s["value"]) & (it > 0))
            low_new = (st >= 0.0) & ~high_new
            pv, ps, pt = s["value"], s["slope"], s["stepsize"]
            sr = {"low": where(low_new, t, pt),
                  "value_low": where(low_new, vt, pv),
                  "slope_low": where(low_new, st, ps),
                  "high": where(low_new, pt, t),
                  "value_high": where(low_new, pv, vt),
                  "slope_high": where(low_new, ps, st)}
            sr.update(cubic_ref=sr["low"], value_cubic_ref=sr["value_low"],
                      interval_found=high_new | low_new | (err <= tol),
                      failed=(it + 1 >= self.max_steps) & ~(err <= tol),
                      safe_stepsize=where(safe, t, s["safe_stepsize"]),
                      safe_value=where(safe, vt, s["safe_value"]),
                      safe_grad=where(_col(safe), gt, s["safe_grad"]))
            # zoom phase (Algorithm 3.6)
            upd_safe = safe & (vt < s["safe_value"])
            to_mid = (dec > 0.0) | (vt >= s["value_low"])
            to_low = (st * (high - low) >= 0.0) & ~to_mid
            low_mid = ~to_mid
            hi = where(to_mid, t, high)
            vhi = where(to_mid, vt, s["value_high"])
            shi = where(to_mid, st, s["slope_high"])
            ref = to_mid | to_low
            new_safe = where(upd_safe, t, s["safe_stepsize"])
            zr = {"high": where(to_low, low, hi),
                  "value_high": where(to_low, s["value_low"], vhi),
                  "slope_high": where(to_low, s["slope_low"], shi),
                  "low": where(low_mid, t, low),
                  "value_low": where(low_mid, vt, s["value_low"]),
                  "slope_low": where(low_mid, st, s["slope_low"]),
                  "cubic_ref": where(ref, high, low),
                  "value_cubic_ref": where(ref, s["value_high"],
                                           s["value_low"]),
                  "interval_found": s["interval_found"],
                  "failed": ((it + 1 >= self.max_steps)
                             | ((delta <= INTERVAL_THRESHOLD)
                                & (new_safe > 0.0))) & ~(err <= tol),
                  "safe_stepsize": new_safe,
                  "safe_value": where(upd_safe, vt, s["safe_value"]),
                  "safe_grad": where(_col(upd_safe), gt, s["safe_grad"])}
            for k in sr:
                n[k] = where(_col(zoom) if sr[k].ndim == 2 else zoom,
                             zr[k], sr[k])
            # a failed search falls back on the safe step (if any)
            fb = n["failed"] & ((n["safe_stepsize"] > 0.0)
                                | torch.isinf(n["decrease_error"]))
            n["stepsize"] = where(fb, n["safe_stepsize"], n["stepsize"])
            n["value"] = where(fb, n["safe_value"], n["value"])
            n["grad"] = where(_col(fb), n["safe_grad"], n["grad"])
            s = {k: where(_col(active) if v.ndim == 2 else active, v, s[k])
                 for k, v in n.items()}

    def update(self, G, state, X, value=None, value_and_grad_fn=None,
               frozen=None):
        d, new = self._direction(G, state, X)
        ls = self._linesearch(d, X, value, G, state["learning_rate"],
                              value_and_grad_fn, frozen)
        lr = ls["stepsize"]
        new.update(learning_rate=lr, value=ls["value"], grad=ls["grad"],
                   num_linesearch_steps=ls["count"],
                   decrease_error=ls["decrease_error"],
                   curvature_error=ls["curvature_error"])
        return _col(lr) * d, new


def make_optimizer(method: str, lr: float, lbfgs_memory: int = 8,
                   linesearch_steps: int = 8):
    """The descent's optimizer, as the JAX package's ``_make_optimizer``
    configures optax: ``adam`` (learning rate ``lr``) or ``lbfgs``
    (memory 8, the zoom linesearch capped at 8 steps; ``lr`` unused)."""
    if method == "adam":
        return Adam(lr)
    if method == "lbfgs":
        return LBFGS(memory_size=lbfgs_memory,
                     max_linesearch_steps=linesearch_steps)
    raise errors.ModelConfigError(
        f"unknown optimize method '{method}' (adam|lbfgs)", method=method)
