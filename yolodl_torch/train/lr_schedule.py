"""Learning-rate schedules.

Counterpart of ``yolodl_tpu/train/lr_schedule.py`` (``tch-goodies/src/
lr_schedule.rs``): Constant and StepWise (piecewise-constant by step
thresholds, must start at step 0, monotonic), plus the darknet [net] policy
family (burn-in warmup, then constant | step | steps | exp | poly | sig |
sgdr).  Resume = evaluate at any step; the schedule is stateless.

:func:`lr_at_step` is the reference's pure-Python evaluation, copied.
:func:`make_schedule_fn` returns a plain ``step → float`` function; the
train step calls it on the host once per optimizer step and writes the
value into the optimizer's ``lr`` (see ``train/loop.py``).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Tuple, Union



@dataclasses.dataclass(frozen=True)
class LrScheduleConfig:
    """type: "constant" | "stepwise" | "darknet"."""

    kind: str = "constant"
    lr: float = 1e-3
    # stepwise: [(step, lr)], first step must be 0, steps strictly increasing
    steps: Tuple[Tuple[int, float], ...] = ()
    # kind="darknet": the full [net] policy family
    # (darknet-test/darknet/src/network.c:131-176).  ``policy`` selects
    # constant | step | steps | exp | poly | sig | sgdr; burn-in warmup
    # (lr·(i/burn_in)^power, :136) precedes every policy.  burn_in_power
    # is darknet's net.power — it also drives poly decay.
    policy: str = "steps"
    darknet_steps: Tuple[int, ...] = ()
    darknet_scales: Tuple[float, ...] = ()
    burn_in: int = 0
    burn_in_power: float = 4.0
    gamma: float = 1.0       # exp decay base / sig steepness
    step_size: int = 1       # STEP divisor; SIG midpoint (net.step)
    step_scale: float = 1.0  # STEP base (net.scale)
    max_batches: int = 0     # poly horizon; default sgdr cycle
    lr_min: float = 1e-5     # sgdr floor (net.learning_rate_min)
    sgdr_cycle: int = 0      # 0 = max_batches (parser.c:1142)
    sgdr_mult: int = 2       # cycle-length multiplier (parser.c:1143)

    def __post_init__(self):
        if self.kind == "stepwise":
            if not self.steps or self.steps[0][0] != 0:
                raise ValueError("stepwise steps must start from zero")
            for (a, la), (b, lb) in zip(self.steps, self.steps[1:]):
                if b <= a:
                    raise ValueError("stepwise steps must be monotonic")
            if any(lr <= 0 for _, lr in self.steps):
                raise ValueError("learning rate must be positive")
        elif self.kind == "constant":
            if self.lr < 0:
                raise ValueError("the lr must be positive")
        elif self.kind == "darknet" and self.policy == "sgdr":
            # cycle 0 would loop forever in the warm-restart seek; darknet
            # itself degrades to NaN here — fail loudly instead
            if not (self.sgdr_cycle or self.max_batches):
                raise ValueError(
                    "policy=sgdr needs sgdr_cycle or max_batches > 0 "
                    "(the restart cycle length would be 0)")
            if self.sgdr_mult < 1:
                raise ValueError(
                    f"sgdr_mult must be >= 1, got {self.sgdr_mult}")

    @staticmethod
    def parse(raw: Union[dict, float, int, None]) -> "LrScheduleConfig":
        """Parse the JSON5 config form: {type: Constant, lr} or
        {type: StepWise, steps: [[step, lr], ...]}."""
        if raw is None:
            return LrScheduleConfig()
        if isinstance(raw, (int, float)):
            return LrScheduleConfig(kind="constant", lr=float(raw))
        if not isinstance(raw, dict):
            raise ValueError(
                f"lr_schedule must be a number or an object, got "
                f"{type(raw).__name__}")
        t = str(raw.get("type", "Constant")).lower()
        if t == "constant":
            return LrScheduleConfig(kind="constant", lr=float(raw["lr"]))
        if t in ("stepwise", "step_wise"):
            steps = tuple((int(s), float(lr)) for s, lr in raw["steps"])
            return LrScheduleConfig(kind="stepwise", steps=steps)
        if t in ("frommodelcfg", "from_model_cfg"):
            # resolved by the CLI against the darknet model cfg's [net]
            # policy (lr_schedule_from_darknet) — lets darknet training
            # recipes run unchanged under the JSON5 config
            return LrScheduleConfig(kind="from_model_cfg")
        raise ValueError(f"unknown lr schedule type {t!r}")


def lr_schedule_from_darknet(net) -> LrScheduleConfig:
    """Build the schedule from a parsed ``[net]`` section
    (:class:`~yolodl_torch.config.darknet_cfg.Net`) — the exact
    get_current_rate policy family, network.c:131-176."""
    policy = net.policy
    if policy == "random":
        raise ValueError(
            "darknet policy=random (lr·rand^power each step) is "
            "non-deterministic and unsupported; pick an explicit schedule")
    if policy not in ("constant", "step", "steps", "exp", "poly", "sig",
                      "sgdr"):
        raise ValueError(f"unknown darknet lr policy {policy!r}")
    if policy == "poly" and net.max_batches <= 0:
        raise ValueError("policy=poly needs max_batches in [net]")
    return LrScheduleConfig(
        kind="darknet", lr=net.learning_rate, policy=policy,
        darknet_steps=net.steps, darknet_scales=net.scales,
        burn_in=net.burn_in, burn_in_power=net.power,
        gamma=net.gamma, step_size=net.step, step_scale=net.scale,
        max_batches=net.max_batches, lr_min=net.learning_rate_min,
        sgdr_cycle=net.sgdr_cycle, sgdr_mult=net.sgdr_mult,
    )


def lr_at_step(config: LrScheduleConfig, step: int) -> float:
    """Host-side scalar evaluation (exact reference semantics)."""
    if config.kind == "constant":
        return config.lr
    if config.kind == "stepwise":
        thresholds = [s for s, _ in config.steps]
        idx = bisect.bisect_right(thresholds, step) - 1
        idx = max(idx, 0)
        return config.steps[idx][1]
    if config.kind == "darknet":
        import math

        lr = config.lr
        if config.burn_in > 0 and step < config.burn_in:
            return lr * (step / config.burn_in) ** config.burn_in_power
        p = config.policy
        if p == "constant":
            return lr
        if p == "step":  # network.c:141
            return lr * config.step_scale ** (step // config.step_size)
        if p == "steps":  # network.c:142-149
            for threshold, scale in zip(config.darknet_steps,
                                        config.darknet_scales):
                if step >= threshold:
                    lr *= scale
            return lr
        if p == "exp":  # network.c:151
            return lr * config.gamma ** step
        if p == "poly":  # network.c:153 (clamped past max_batches)
            if config.max_batches <= 0:
                raise ValueError("poly policy needs max_batches > 0")
            frac = max(1.0 - step / config.max_batches, 0.0)
            return lr * frac ** config.burn_in_power
        if p == "sig":  # network.c:159
            return lr / (1.0 + math.exp(
                config.gamma * (step - config.step_size)))
        if p == "sgdr":  # cosine warm restarts, network.c:160-174
            cycle = config.sgdr_cycle or config.max_batches
            last = 0
            while last + cycle < step:
                last += cycle
                cycle *= config.sgdr_mult
            return config.lr_min + 0.5 * (lr - config.lr_min) * (
                1.0 + math.cos((step - last) * math.pi / cycle))
        raise ValueError(f"unsupported darknet lr policy {p!r}")
    raise ValueError(f"unknown schedule kind {config.kind!r}")


def make_schedule_fn(config: LrScheduleConfig) -> Callable[[int], float]:
    """Plain ``step → lr`` function, :func:`lr_at_step` of ``config``.

    Raises at construction for a kind or policy that :func:`lr_at_step`
    would refuse, as the reference's traced version does."""
    if config.kind not in ("constant", "stepwise", "darknet"):
        raise ValueError(f"unknown schedule kind {config.kind!r}")
    if config.kind == "darknet":
        if config.policy not in ("constant", "step", "steps", "exp", "poly", "sig", "sgdr"):
            raise ValueError(f"unsupported darknet lr policy {config.policy!r}")
        if config.policy == "poly" and config.max_batches <= 0:
            raise ValueError("poly policy needs max_batches > 0")

    def schedule(step) -> float:
        return lr_at_step(config, int(step))

    return schedule
