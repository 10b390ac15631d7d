"""ETA regressor: an MLP over the 12-feature encoding, as an ``nn.Module``.

The counterpart of ``routest_tpu/models/eta_mlp.py``. The external
contract is the reference's 12 features; inside, the model expands them
into bases (weekday/hour one-hots, normalized distance and age,
log-distance) and predicts a **pace** (min/km) and an **overhead** (min)
head pair, ``eta = pace · distance + overhead``. With ``quantiles`` the
heads become one pair per quantile whose later members add
softplus-positive increments, so quantiles never cross.

:meth:`EtaMLP.from_numpy` is the weight carry-over: the JAX params
pytree as numpy arrays goes in, and the module computes what the JAX
``EtaMLP.apply`` / ``apply_quantiles`` compute; :meth:`EtaMLP.to_numpy`
is its inverse, and :meth:`EtaMLP.init` draws the JAX ``init``'s weights
from the port's threefry (``core/prng.py``). The feature normalizer is a
pair of buffers: it gets no gradient and no weight decay, as the JAX
package's ``stop_gradient`` and decay mask give it. As in the JAX ``_trunk``,
the bias add and gelu run in the policy's compute dtype; the serving
kernel (``ops/fused_mlp.py``) does both in f32 instead, as the Pallas
kernel does. Serving goes through that kernel; this module is the
reference the tests and ``chip_smoke.py`` hold it against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from routest_tpu_torch.core import prng
from routest_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from routest_tpu_torch.data.features import N_FEATURES

_N_HOURS = 24
_N_WEEKDAYS = 7
# internal width: weather(4) + traffic(4) + weekday_oh(7) + hour_oh(24)
# + [dist_norm, log_dist, age_norm]
_INTERNAL_FEATURES = 4 + 4 + _N_WEEKDAYS + _N_HOURS + 3


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) without torch's
    linear-above-threshold shortcut."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _cumsum_matrix(n_q: int, dtype, device) -> torch.Tensor:
    """(2Q, 2Q) block-diagonal upper-triangular ones: ``sp @ M`` computes
    both head cumsums (pace cols 0..Q-1, overhead cols Q..2Q-1)."""
    tri = torch.triu(torch.ones((n_q, n_q), dtype=dtype, device=device))
    return torch.block_diag(tri, tri)


def quantile_heads(out: torch.Tensor, dist_km: torch.Tensor,
                   n_q: int) -> torch.Tensor:
    """Non-crossing quantile epilogue in the JAX package's matmul form:
    raw heads (…, 2Q) + distance (…,) → per-quantile minutes (…, Q)."""
    sp = softplus(out[..., : 2 * n_q])
    cum = sp @ _cumsum_matrix(n_q, sp.dtype, sp.device)
    return cum[..., :n_q] * dist_km[..., None] + cum[..., n_q:]


def quantile_heads_unfused(out: torch.Tensor, dist_km: torch.Tensor,
                           n_q: int) -> torch.Tensor:
    """Scan-form oracle for :func:`quantile_heads`: explicit cumsum per
    head family."""
    pace = torch.cumsum(softplus(out[..., :n_q]), dim=-1)
    overhead = torch.cumsum(softplus(out[..., n_q:2 * n_q]), dim=-1)
    return pace * dist_km[..., None] + overhead


def host_array(t: torch.Tensor) -> np.ndarray:
    """A float32 host copy of a parameter or buffer."""
    return t.detach().to("cpu", torch.float32).numpy().copy()


def layers_to_numpy(linears) -> list:
    """``nn.Linear`` layers → the JAX ``[{"b": (out,), "w": (in, out)}]``."""
    return [{"b": host_array(linear.bias),
             "w": np.ascontiguousarray(host_array(linear.weight).T)}
            for linear in linears]


@torch.no_grad()
def init_layers(linears, key: torch.Tensor) -> torch.Tensor:
    """The JAX packages' He init in place: per layer ``key, sub =
    split(key)``, ``w = normal(sub, (d_in, d_out)) · sqrt(2 / d_in)``,
    zero bias. Draws on the key's device; returns the advanced key."""
    for linear in linears:
        key, sub = prng.split(key, 2)
        d_in = linear.in_features
        scale = torch.tensor(np.sqrt(np.float32(2.0 / d_in)),
                             device=key.device)
        w = prng.normal(sub, (d_in, linear.out_features)) * scale
        linear.weight.copy_(w.T)
        linear.bias.zero_()
    return key


class EtaMLP(nn.Module):
    """``forward`` is the JAX ``EtaMLP.apply`` — (B, 12) ABI features →
    (B,) ETA minutes, the median head for a quantile model — and
    :meth:`apply_quantiles` its namesake."""

    def __init__(self, hidden: Tuple[int, ...] = (256, 256, 128),
                 n_features: int = N_FEATURES,
                 policy: Policy = DEFAULT_POLICY,
                 quantiles: Tuple[float, ...] = ()) -> None:
        super().__init__()
        q = tuple(quantiles)
        if q:
            if list(q) != sorted(q) or len(set(q)) != len(q):
                raise ValueError(f"quantiles must be strictly increasing: {q}")
            if not all(0.0 < v < 1.0 for v in q):
                raise ValueError(f"quantiles must lie in (0, 1): {q}")
            if 0.5 not in q:
                raise ValueError(f"quantiles must include 0.5: {q}")
        self.hidden = tuple(hidden)
        self.n_features = n_features
        self.policy = policy
        self.quantiles = q
        dims = (_INTERNAL_FEATURES,) + self.hidden + (self.n_heads,)
        self.layers = nn.ModuleList(
            nn.Linear(d_in, d_out, dtype=policy.param_dtype)
            for d_in, d_out in zip(dims[:-1], dims[1:]))
        self.register_buffer("norm_mean", torch.zeros(n_features))
        self.register_buffer("norm_std", torch.ones(n_features))

    @property
    def n_heads(self) -> int:
        return 2 * max(1, len(self.quantiles))

    @classmethod
    def from_numpy(cls, params, hidden: Tuple[int, ...],
                   quantiles: Tuple[float, ...] = (),
                   policy: Policy = DEFAULT_POLICY) -> "EtaMLP":
        """JAX params pytree (numpy leaves: ``layers`` = list of
        ``{"w": (in, out), "b": (out,)}``, ``norm`` = ``{"mean", "std"}``)
        → a module computing the same function."""
        model = cls(hidden=hidden, policy=policy, quantiles=quantiles)
        layers = params["layers"]
        if len(layers) != len(model.layers):
            raise ValueError(f"params carry {len(layers)} layers, "
                             f"hidden={tuple(hidden)} needs {len(model.layers)}")
        with torch.no_grad():
            for linear, layer in zip(model.layers, layers):
                w = torch.from_numpy(np.array(layer["w"], np.float32))
                if tuple(w.shape) != (linear.in_features, linear.out_features):
                    raise ValueError(
                        f"layer weight {tuple(w.shape)} does not fit "
                        f"({linear.in_features}, {linear.out_features})")
                linear.weight.copy_(w.T)
                linear.bias.copy_(torch.from_numpy(
                    np.array(layer["b"], np.float32)))
            model.norm_mean.copy_(torch.from_numpy(
                np.array(params["norm"]["mean"], np.float32)))
            model.norm_std.copy_(torch.from_numpy(
                np.array(params["norm"]["std"], np.float32)))
        return model

    @torch.no_grad()
    def init(self, key: torch.Tensor,
             norm_mean: Optional[np.ndarray] = None,
             norm_std: Optional[np.ndarray] = None) -> "EtaMLP":
        """The JAX ``EtaMLP.init`` in place: per layer ``key, sub =
        split(key)``, ``w = normal(sub, (d_in, d_out)) · sqrt(2 / d_in)``,
        zero biases; normalizer stats with stds below 1e-3 floored to 1.
        Draws on the host, then copies to the module's device."""
        init_layers(self.layers, key.cpu())
        mean = (np.zeros(self.n_features, np.float32) if norm_mean is None
                else np.asarray(norm_mean, np.float32))
        std = (np.ones(self.n_features, np.float32) if norm_std is None
               else np.asarray(norm_std, np.float32))
        std = np.where(std < 1e-3, np.float32(1.0), std)
        self.norm_mean.copy_(torch.from_numpy(mean))
        self.norm_std.copy_(torch.from_numpy(std))
        return self

    def to_numpy(self) -> dict:
        """The JAX params pytree (numpy leaves, ``w`` as ``(in, out)``):
        the inverse of :meth:`from_numpy`."""
        return {"layers": layers_to_numpy(self.layers),
                "norm": {"mean": host_array(self.norm_mean),
                         "std": host_array(self.norm_std)}}

    def _expand(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ABI features (B,12) → internal bases (B,42) + distance_km (B,)."""
        cat = x[..., 0:8]
        weekday = x[..., 8].to(torch.int32)   # truncation, like astype(int32)
        hour = x[..., 9].to(torch.int32)
        # Clamp distance once: a negative distance from a malformed
        # request must not produce a negative ETA downstream.
        dist_km = torch.clamp_min(x[..., 10], 0.0)
        age = x[..., 11]
        # index outside [0, n) → all-zero group, like jax.nn.one_hot
        wd_oh = (weekday[..., None] == torch.arange(
            _N_WEEKDAYS, device=x.device)).to(x.dtype)
        hr_oh = (hour[..., None] == torch.arange(
            _N_HOURS, device=x.device)).to(x.dtype)
        dist_n = (dist_km - self.norm_mean[10]) / self.norm_std[10]
        age_n = (age - self.norm_mean[11]) / self.norm_std[11]
        log_dist = torch.log1p(dist_km)
        feats = torch.cat(
            [cat, wd_oh, hr_oh,
             dist_n[..., None], log_dist[..., None], age_n[..., None]],
            dim=-1)
        return feats, dist_km

    def _trunk(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shared forward: raw head outputs (B, n_heads) + distance."""
        compute = self.policy.compute_dtype
        feats, dist_km = self._expand(x)
        h = feats.to(compute)
        for linear in self.layers[:-1]:
            h = F.gelu(h @ linear.weight.to(compute).T
                       + linear.bias.to(compute), approximate="tanh")
        last = self.layers[-1]
        out = h @ last.weight.to(compute).T + last.bias.to(compute)
        return (out.to(self.policy.output_dtype),
                dist_km.to(self.policy.output_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantiles:
            return self.apply_quantiles(x)[..., self.quantiles.index(0.5)]
        out, dist_km = self._trunk(x)
        return softplus(out[..., 0]) * dist_km + softplus(out[..., 1])

    def apply_quantiles(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 12) → (B, Q) ETA minutes per quantile, non-crossing."""
        if not self.quantiles:
            raise ValueError("apply_quantiles on a point model; "
                             "construct EtaMLP(quantiles=...)")
        out, dist_km = self._trunk(x)
        return quantile_heads(out, dist_km, len(self.quantiles))


def fit_normalizer(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/std over the training features. ``init`` replaces near-zero
    stds (constant columns) with 1.0 so unseen categories can't explode."""
    return (features.mean(axis=0).astype(np.float32),
            features.std(axis=0).astype(np.float32))
