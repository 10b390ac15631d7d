"""Training loop for the ETA model, on the serving device.

The counterpart of ``routest_tpu/train/loop.py`` (there: a jitted step,
optax, pure data parallelism over a mesh). Here one device trains:
autograd differentiates the plain ``EtaMLP`` forward, as
``jax.value_and_grad`` does the JAX one (neither package has a backward
kernel), and the optimizer is a few lines that follow optax's order of
operations instead of ``torch.optim.AdamW``'s:

- the schedule is optax's ``warmup_cosine_decay_schedule`` read at the
  update count *before* the step, so the first update has learning
  rate 0;
- the clip is optax's ``clip_by_global_norm``: ``g`` when ``‖g‖ < 1``,
  else ``g / ‖g‖`` (no epsilon in the norm);
- Adam's ``mu / (sqrt(nu) + eps)`` after bias correction, then the
  decoupled decay added to the update (weights only: biases and the
  normalizer buffers are not decayed), then ``p - lr · update``.

The whole step stays on the device: the clip's branch is a ``where``,
and the loss is read once per epoch. Shuffles are
``np.random.default_rng(seed + 1 + epoch)`` permutations, so an epoch
shuffles identically whether or not the run was resumed; the last batch
of an epoch is short (one device: no padding). Data parallelism over
several cards (the JAX ``MeshRuntime`` path) waits for Queue A item 9.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from routest_tpu_torch.core import prng
from routest_tpu_torch.core.config import TrainConfig, resolve_device
from routest_tpu_torch.data.features import batch_from_mapping
from routest_tpu_torch.models.eta_mlp import EtaMLP, fit_normalizer
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.train")

Schedule = Callable[[int], float]

_F32 = np.float32


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax's ``linear_schedule``, in float32."""
    def schedule(count: int) -> float:
        frac = _F32(1.0) - _F32(min(max(count, 0), transition_steps)) \
            / _F32(transition_steps)
        return float(_F32(init_value - end_value) * frac + _F32(end_value))
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax's ``cosine_decay_schedule`` (exponent 1), in float32."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, "
                         f"got {decay_steps}")

    def schedule(count: int) -> float:
        c = _F32(min(count, decay_steps))
        cosine = _F32(0.5) * (_F32(1.0) + np.cos(
            _F32(math.pi) * c / _F32(decay_steps)))
        decayed = _F32(1.0 - alpha) * cosine + _F32(alpha)
        return float(_F32(init_value) * decayed)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    down to ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)

    def schedule(count: int) -> float:
        return warm(count) if count < warmup_steps \
            else decay(count - warmup_steps)
    return schedule


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float = 1.0) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: the gradients unchanged when
    their global norm is below ``max_norm``, else scaled to it. The
    branch is a ``where`` on the device (no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


class AdamW:
    """optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root) over an explicit parameter list, with optional
    ``clip_by_global_norm`` in front of it. ``decay[i]`` says whether
    parameter ``i`` takes the decoupled weight decay; ``learning_rate``
    is a float or a schedule of the update count."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Sequence[torch.Tensor], learning_rate,
                 weight_decay: float, decay: Optional[Sequence[bool]] = None,
                 clip_norm: Optional[float] = None) -> None:
        self.params = list(params)
        self.learning_rate = learning_rate
        self.weight_decay = float(weight_decay)
        self.decay = (list(decay) if decay is not None
                      else [True] * len(self.params))
        if len(self.decay) != len(self.params):
            raise ValueError("one decay flag per parameter")
        self.clip_norm = clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        count = self.count + 1
        bc1 = float(_F32(1.0) - _F32(self.b1) ** _F32(count))
        bc2 = float(_F32(1.0) - _F32(self.b2) ** _F32(count))
        neg_lr = -self.lr(self.count)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            self.mu[i] = (1.0 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[i]
            update = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2)
                                           + self.eps)
            if self.decay[i]:
                update = update + self.weight_decay * p
            p.add_(neg_lr * update)
        self.count = count

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "mu": [m.detach().cpu() for m in self.mu],
                "nu": [n.detach().cpu() for n in self.nu]}

    def load_state_dict(self, state: Dict) -> None:
        if len(state["mu"]) != len(self.params):
            raise ValueError("optimizer state does not fit the parameters")
        self.count = int(state["count"])
        self.mu = [m.to(p.device) for m, p in zip(state["mu"], self.params)]
        self.nu = [n.to(p.device) for n, p in zip(state["nu"], self.params)]


def _eta_params(model: EtaMLP) -> Tuple[List[torch.Tensor], List[bool]]:
    """The trainable tensors in the JAX pytree's leaf order (per layer
    ``b`` then ``w``) with their decay flags: weights only (the JAX
    ``_decay_mask``)."""
    params, decay = [], []
    for linear in model.layers:
        params += [linear.bias, linear.weight]
        decay += [False, True]
    return params, decay


def make_optimizer(model: EtaMLP, cfg: TrainConfig,
                   total_steps: int = 1000) -> AdamW:
    """The JAX ``make_optimizer``: global-norm clip at 1, then AdamW on a
    warmup-cosine schedule (warmup ``max(1, min(100, total // 10))``,
    ending at 5% of the peak), decay on the weights only."""
    warmup = max(1, min(100, total_steps // 10))
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate, warmup_steps=warmup,
        decay_steps=max(total_steps, warmup + 1),
        end_value=cfg.learning_rate * 0.05)
    params, decay = _eta_params(model)
    return AdamW(params, schedule, cfg.weight_decay, decay=decay,
                 clip_norm=1.0)


def huber_loss(pred: torch.Tensor, targets: torch.Tensor,
               delta: float) -> torch.Tensor:
    """optax's ``huber_loss``, term for term."""
    abs_err = torch.abs(pred - targets)
    quadratic = torch.clamp_max(abs_err, delta)
    return 0.5 * quadratic ** 2 + delta * (abs_err - quadratic)


def loss_fn(model: EtaMLP, features: torch.Tensor, targets: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """Row-weighted mean loss: the pinball loss averaged over the heads
    for a quantile model, Huber (delta 10 minutes) for a point model."""
    denom = torch.clamp_min(weights.sum(), 1.0)
    if model.quantiles:
        pred = model.apply_quantiles(features)
        q = torch.tensor(model.quantiles, dtype=pred.dtype,
                         device=pred.device)
        err = targets[:, None] - pred
        per_row = torch.maximum(q * err, (q - 1.0) * err).mean(dim=-1)
    else:
        per_row = huber_loss(model(features), targets, 10.0)
    return (per_row * weights).sum() / denom


def make_train_step(model: EtaMLP, optimizer: AdamW) -> Callable:
    """``step(features, targets, weights) -> loss``: one value-and-grad
    and one optimizer update, all on the model's device."""
    def step(features: torch.Tensor, targets: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
        loss = loss_fn(model, features, targets, weights)
        grads = torch.autograd.grad(loss, optimizer.params)
        optimizer.step(grads)
        return loss.detach()
    return step


def _minibatches(features: torch.Tensor, targets: torch.Tensor,
                 batch_size: int, rng: np.random.Generator
                 ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]]:
    """One epoch of ``(features, targets, weights)`` batches in ``rng``'s
    permutation order, gathered on the tensors' device; the last batch
    is short."""
    n = len(targets)
    perm = torch.from_numpy(rng.permutation(n)).to(targets.device)
    ones = torch.ones(min(batch_size, n), dtype=torch.float32,
                      device=targets.device)
    for start in range(0, n, batch_size):
        idx = perm[start:start + batch_size]
        yield features[idx], targets[idx], ones[:len(idx)]


@torch.no_grad()
def rmse(model: EtaMLP, data: Dict[str, np.ndarray],
         batch_size: int = 65536) -> float:
    """Exact RMSE of the model on a dataset dict (``data/synthetic.py``
    schema), scored on the model's device in chunks."""
    device = model.norm_mean.device
    features = batch_from_mapping(data)
    targets = np.asarray(data["eta_minutes"], np.float32)
    total_sse, total_n = 0.0, 0
    for start in range(0, len(targets), batch_size):
        x = torch.from_numpy(features[start:start + batch_size]).to(device)
        y = torch.from_numpy(targets[start:start + batch_size]).to(device)
        total_sse += float(((model(x) - y) ** 2).sum())
        total_n += len(y)
    return float(np.sqrt(total_sse / max(total_n, 1)))


@dataclasses.dataclass
class FitResult:
    model: EtaMLP
    optimizer: AdamW
    train_losses: list
    eval_rmse: float

    @property
    def params(self) -> Dict:
        """The trained params as the JAX pytree (numpy leaves)."""
        return self.model.to_numpy()


def _checkpoint_state(model: EtaMLP, optimizer: AdamW, epoch: int) -> Dict:
    return {"params": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
            "opt": optimizer.state_dict(), "step": optimizer.count,
            "epoch": epoch}


def fit(model: EtaMLP, train_data: Dict[str, np.ndarray],
        eval_data: Dict[str, np.ndarray], cfg: Optional[TrainConfig] = None,
        log_every: int = 0, device=None) -> FitResult:
    """Full training run on a dataset dict: init from ``cfg.seed`` with
    the training set's normalizer, resume from ``cfg.checkpoint_dir``
    when it holds a checkpoint, train to ``cfg.epochs`` (or
    ``stop_after_epochs`` more), and score ``eval_data``. Trains on
    ``device`` (default: the serving device, the card)."""
    from routest_tpu_torch.train import checkpoint as ckpt

    cfg = cfg or TrainConfig()
    dev = resolve_device(device, "fit")
    features = batch_from_mapping(train_data)
    targets = np.asarray(train_data["eta_minutes"], np.float32)
    if len(targets) == 0:
        raise ValueError("fit: training set is empty")

    mean, std = fit_normalizer(features)
    model.init(prng.prng_key(cfg.seed), norm_mean=mean, norm_std=std)
    model.to(dev)
    steps_per_epoch = max(1, -(-len(targets) // cfg.batch_size))
    optimizer = make_optimizer(model, cfg,
                               total_steps=cfg.epochs * steps_per_epoch)

    start_epoch = 0
    if cfg.checkpoint_dir:
        found = ckpt.latest_checkpoint_step(cfg.checkpoint_dir)
        if found is not None:
            start_epoch, latest = found
            state = ckpt.restore_checkpoint(latest)
            model.load_state_dict(state["params"])
            optimizer.load_state_dict(state["opt"])
            if log_every:
                _log.info("train_resumed", checkpoint=latest,
                          epoch=start_epoch)

    end_epoch = cfg.epochs
    if cfg.stop_after_epochs is not None:
        # A preemptible slice: a bounded number of epochs of the FULL
        # schedule. 0 is a valid budget: restore, train nothing, score.
        if cfg.stop_after_epochs < 0:
            raise ValueError("stop_after_epochs must be >= 0")
        end_epoch = min(cfg.epochs, start_epoch + cfg.stop_after_epochs)

    step_fn = make_train_step(model, optimizer)
    x_dev = torch.from_numpy(features).to(dev)
    y_dev = torch.from_numpy(targets).to(dev)
    losses: List[float] = []
    saved_epoch = start_epoch
    reg = get_registry()
    m_epoch_s = reg.histogram("rtpu_train_epoch_seconds",
                              "Wall time per training epoch.")
    m_loss = reg.gauge("rtpu_train_loss", "Last epoch's training loss.")
    m_epochs = reg.counter("rtpu_train_epochs_total",
                           "Training epochs completed.")
    for epoch in range(start_epoch, end_epoch):
        t_epoch = time.perf_counter()
        rng = np.random.default_rng(cfg.seed + 1 + epoch)
        for x, y, w in _minibatches(x_dev, y_dev, cfg.batch_size, rng):
            loss = step_fn(x, y, w)
        losses.append(float(loss))
        epoch_s = time.perf_counter() - t_epoch
        m_epoch_s.observe(epoch_s)
        m_loss.set(losses[-1])
        m_epochs.inc()
        if log_every and (epoch + 1) % log_every == 0:
            _log.info("train_epoch", epoch=epoch + 1, epochs=cfg.epochs,
                      loss=round(losses[-1], 4),
                      epoch_seconds=round(epoch_s, 3))
        if (cfg.checkpoint_dir and cfg.checkpoint_every_epochs
                and (epoch + 1) % cfg.checkpoint_every_epochs == 0):
            ckpt.save_checkpoint(cfg.checkpoint_dir, epoch + 1,
                                 _checkpoint_state(model, optimizer,
                                                   epoch + 1))
            saved_epoch = epoch + 1

    if (cfg.checkpoint_dir and cfg.stop_after_epochs is not None
            and saved_epoch != end_epoch):
        # A slice always persists its endpoint: ending between periodic
        # saves would make the next invocation redo this slice's work.
        ckpt.save_checkpoint(cfg.checkpoint_dir, end_epoch,
                             _checkpoint_state(model, optimizer, end_epoch))

    return FitResult(model=model, optimizer=optimizer, train_losses=losses,
                     eval_rmse=rmse(model, eval_data))
