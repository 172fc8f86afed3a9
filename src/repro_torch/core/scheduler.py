"""Learned operator scheduling (port of ``repro.core.scheduler``;
DESIGN.md §16): a contextual bandit over the memetic operator menu in the
uncoarsening ladder.

Host-side numpy only, copied from the reference so that the port never
imports it.  The arms are the driver's existing dispatches

* ``lp``        — the LP tier alone (``refine.lp_refine_population``);
* ``lp_fm``     — LP + FM, the static schedule's per-level refinement
  (``refine.refine_population``);
* ``mutate``    — the mutation cohort V-cycle (``mutate_population``);
* ``recombine`` — the recombination ring (``ring_recombination``);

and the reward is **cut improvement per wall-clock second** (best-cut
delta over the dispatch, divided by its wall).  The bandit only reorders
which dispatches run, so every dispatch stays bit-identical to its
scheduled twin and ``REPRO_SCHED=static`` remains the static program.

Policies (``ImpartConfig.sched_policy``): ``ucb1`` (default; per-context
UCB with rewards normalised by the running max) and ``egreedy``.  Both
draw their randomness from a crc32-derived PRNG (:func:`sched_prng_seed`,
base seed overridable via ``REPRO_SCHED_SEED``), and every decision is
logged to a :class:`SchedulerTrace`: a scheduler constructed with
``replay=trace`` returns the logged arm sequence verbatim (contexts
asserted), so a bandit run is reproducible from its serialized trace
even though live rewards depend on the wall clock.  Traces serialize to
the reference's JSON wire shape, so a trace written by either package
replays in the other; scheduler state snapshots to JSON-able dicts.
"""
from __future__ import annotations

import dataclasses
import math
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.env import warn_env_once

SCHED_PATHS = ("bandit", "static")

# the full operator menu, and the subset every ladder level must pick
# its mandatory refinement from (phase 0)
ARMS = ("lp", "lp_fm", "mutate", "recombine")
REFINE_ARMS = ("lp", "lp_fm")

POLICIES = ("ucb1", "egreedy")

# the scheduler context phase for refinement decisions inside a final
# V-cycle (``vcycle(scheduler=...)``) — negative so it can never collide
# with the ladder's phase numbering (>= 0), which is what lets replay
# tell a level-0 optional slot from a V-cycle decision at level 0
SCHED_VCYCLE_PHASE = -1


def sched_path() -> str:
    """``REPRO_SCHED=bandit|static`` routing (``auto`` = ``static``:
    the learned schedule is opt-in because the static program is the
    parity baseline every other path is proven against)."""
    env = os.environ.get("REPRO_SCHED", "auto").strip().lower()
    if env in SCHED_PATHS:
        return env
    if env not in ("", "auto"):
        warn_env_once("REPRO_SCHED", env, "static (auto)")
    return "static"


def resolve_sched(override: Optional[str] = None) -> str:
    """Resolve a per-call / per-config override against the env default
    (mirrors ``popshard.resolve``): ``None``/``"auto"`` defers to
    ``REPRO_SCHED``; anything else must name a path."""
    if override is None:
        return sched_path()
    override = override.strip().lower()
    if override == "auto":
        return sched_path()
    if override not in SCHED_PATHS:
        raise ValueError(f"unknown sched path {override!r}; expected one "
                         f"of {SCHED_PATHS + ('auto',)}")
    return override


def sched_prng_seed(base_seed: int) -> int:
    """The scheduler PRNG seed: crc32-derived (like the benchmark
    seeding — process-salted ``hash()`` would make logged traces
    irreproducible) from the config seed, or from ``REPRO_SCHED_SEED``
    when set (unparsable values warn once and fall back to the config
    seed)."""
    raw = os.environ.get("REPRO_SCHED_SEED", "").strip()
    if raw:
        try:
            base_seed = int(raw)
        except ValueError:
            warn_env_once("REPRO_SCHED_SEED", raw,
                          f"the config seed ({base_seed})")
    return zlib.crc32(f"sched:{base_seed}".encode())


@dataclasses.dataclass
class SchedulerDecision:
    """One logged bandit decision: the (level, phase) context, the arm
    pulled, and the observed outcome — best-cut improvement, dispatch
    wall, and the reward (improvement / wall) the bandit trained on."""
    level: int
    phase: int
    arm: str
    improvement: float = 0.0
    wall_s: float = 0.0
    reward: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "SchedulerDecision":
        return cls(level=int(d["level"]), phase=int(d["phase"]),
                   arm=str(d["arm"]),
                   improvement=float(d.get("improvement", 0.0)),
                   wall_s=float(d.get("wall_s", 0.0)),
                   reward=float(d.get("reward", 0.0)))


@dataclasses.dataclass
class SchedulerTrace:
    """The complete, replayable record of one scheduled run: policy,
    PRNG seed, the decision sequence, and how many final V-cycles the
    driver ran (wall-budget checks make that count non-deterministic
    live, so replay takes it from the trace instead of the clock)."""
    policy: str = "ucb1"
    seed: int = 0
    decisions: List[SchedulerDecision] = dataclasses.field(
        default_factory=list)
    final_vcycles: int = 0

    def arm_sequence(self) -> List[str]:
        return [d.arm for d in self.decisions]

    def histogram(self) -> Dict[str, Dict[str, float]]:
        """Per-arm pulls / total / mean reward (the ``BENCH_sched.json``
        per-row histogram)."""
        out: Dict[str, Dict[str, float]] = {}
        for d in self.decisions:
            h = out.setdefault(d.arm, {"pulls": 0, "total_reward": 0.0})
            h["pulls"] += 1
            h["total_reward"] += d.reward
        for h in out.values():
            h["mean_reward"] = h["total_reward"] / max(h["pulls"], 1)
        return out

    def to_json(self) -> dict:
        return {"policy": self.policy, "seed": self.seed,
                "final_vcycles": self.final_vcycles,
                "decisions": [d.to_json() for d in self.decisions]}

    @classmethod
    def from_json(cls, d: dict) -> "SchedulerTrace":
        return cls(policy=str(d.get("policy", "ucb1")),
                   seed=int(d.get("seed", 0)),
                   final_vcycles=int(d.get("final_vcycles", 0)),
                   decisions=[SchedulerDecision.from_json(x)
                              for x in d.get("decisions", [])])


class OperatorScheduler:
    """Per-(level, phase) contextual bandit over the operator menu.

    Host-side state only: per-context arm statistics (pulls, total
    reward, running max |reward| for normalisation), a crc32-seeded
    ``np.random.Generator``, and the growing :class:`SchedulerTrace`.
    The driver calls :meth:`choose` for an arm and :meth:`observe` with
    the outcome; with ``replay=`` it returns the logged sequence
    instead (asserting each context matches), which is what makes every
    bandit run reproducible after the fact.
    """

    def __init__(self, seed: int = 0, policy: str = "ucb1",
                 epsilon: float = 0.1, ucb_c: float = math.sqrt(2.0),
                 replay: Optional[SchedulerTrace] = None):
        policy = policy.strip().lower()
        if policy not in POLICIES:
            raise ValueError(f"unknown scheduler policy {policy!r}; "
                             f"expected one of {POLICIES}")
        self.policy = policy
        self.seed = int(seed)
        self.epsilon = float(epsilon)
        self.ucb_c = float(ucb_c)
        self.rng = np.random.default_rng(sched_prng_seed(self.seed))
        # (level, phase) -> arm -> [pulls, total_reward].  Contexts are
        # mostly visited ONCE per run (the ladder passes each (level,
        # phase) slot a single time), so choices blend the context's own
        # evidence with the run-global per-arm aggregate (context
        # counted twice = the contextual back-off prior); without the
        # back-off the bandit would never leave its optimistic-init
        # stage.
        self.stats: Dict[Tuple[int, int], Dict[str, List[float]]] = {}
        self._gmax = 0.0  # running max |reward| for normalisation
        self.trace = SchedulerTrace(policy=policy, seed=self.seed)
        self.replay = replay
        self._replay_i = 0

    # -- replay cursor -----------------------------------------------------
    @property
    def replaying(self) -> bool:
        return self.replay is not None

    def _replay_next(self) -> Optional[SchedulerDecision]:
        if self.replay is None or self._replay_i >= len(
                self.replay.decisions):
            return None
        return self.replay.decisions[self._replay_i]

    def replay_has_level(self, level: int) -> bool:
        """True while the trace still has decisions for ``level`` — a
        live run that fast-forwarded (budget exhaustion) simply stops
        logging, so an exhausted trace tells the replaying driver to
        fast-forward at exactly the same ladder position."""
        nxt = self._replay_next()
        return nxt is not None and nxt.level == level

    def replay_pending(self, level: int, phase: int) -> bool:
        """True when the next logged decision is exactly (level, phase)
        — drives the optional-slot loop during replay."""
        nxt = self._replay_next()
        return (nxt is not None and nxt.level == level
                and nxt.phase == phase)

    def replay_final_vcycles(self) -> int:
        return 0 if self.replay is None else self.replay.final_vcycles

    # -- the bandit --------------------------------------------------------
    def _ctx(self, level: int, phase: int) -> Dict[str, List[float]]:
        return self.stats.setdefault((int(level), int(phase)), {})

    def _blended(self, level: int, phase: int, arms: Sequence[str]
                 ) -> Dict[str, Tuple[int, float]]:
        """Choice statistics for a context: the run-global per-arm
        aggregate plus the context's own evidence again (so a context
        that HAS been seen weighs its local outcome double)."""
        ctx = self.stats.get((int(level), int(phase)), {})
        out: Dict[str, Tuple[int, float]] = {}
        for a in arms:
            p, t = 0, 0.0
            for c in self.stats.values():
                if a in c:
                    p += c[a][0]
                    t += c[a][1]
            cp, ct = ctx.get(a, (0, 0.0))
            out[a] = (p + cp, t + ct)
        return out

    def choose(self, level: int, phase: int,
               arms: Sequence[str] = ARMS) -> str:
        """Pick an arm for context (level, phase) from ``arms``."""
        if not arms:
            raise ValueError("empty arm menu")
        for a in arms:
            if a not in ARMS:
                raise ValueError(f"unknown arm {a!r}; menu is {ARMS}")
        if self.replaying:
            nxt = self._replay_next()
            if nxt is None:
                raise RuntimeError(
                    "replay trace exhausted; the driver should have "
                    "fast-forwarded (replay_has_level)")
            if (nxt.level, nxt.phase) != (int(level), int(phase)):
                raise RuntimeError(
                    f"replay divergence: trace has decision at "
                    f"(level={nxt.level}, phase={nxt.phase}), driver "
                    f"asked for (level={level}, phase={phase})")
            self._replay_i += 1
            return nxt.arm
        stats = self._blended(level, phase, arms)
        # optimistic init: an arm never pulled anywhere runs once,
        # menu order
        unpulled = [a for a in arms if stats[a][0] == 0]
        if unpulled:
            return unpulled[0]
        if self.policy == "egreedy":
            if self.rng.random() < self.epsilon:
                return str(self.rng.choice(list(arms)))
            return self._argmax_mean(stats, arms)
        # UCB1 on the blended statistics: normalised mean + exploration
        # bonus
        total = sum(stats[a][0] for a in arms)
        scale = max(self._gmax, 1e-12)
        best_arm, best_val = None, -np.inf
        for a in arms:
            pulls, tot = stats[a]
            mean = (tot / pulls) / scale
            val = mean + self.ucb_c * math.sqrt(
                math.log(max(total, 2)) / pulls)
            val += 1e-12 * self.rng.random()  # PRNG tie-break
            if val > best_val:
                best_arm, best_val = a, val
        return best_arm

    def _argmax_mean(self, stats, arms) -> str:
        best_arm, best_val = None, -np.inf
        for a in arms:
            pulls, tot = stats[a]
            val = tot / max(pulls, 1) + 1e-12 * self.rng.random()
            if val > best_val:
                best_arm, best_val = a, val
        return best_arm

    def observe(self, level: int, phase: int, arm: str,
                improvement: float, wall_s: float) -> SchedulerDecision:
        """Record the outcome of a pulled arm.  Reward = best-cut
        improvement per wall-clock second — computed from the same cut
        values the refinement/metrics path reports, never a separate
        estimate."""
        reward = float(improvement) / max(float(wall_s), 1e-9)
        ctx = self._ctx(level, phase)
        pulls, tot = ctx.get(arm, [0, 0.0])
        ctx[arm] = [pulls + 1, tot + reward]
        self._gmax = max(self._gmax, abs(reward))
        dec = SchedulerDecision(level=int(level), phase=int(phase),
                                arm=arm, improvement=float(improvement),
                                wall_s=float(wall_s), reward=reward)
        self.trace.decisions.append(dec)
        return dec

    # -- snapshot / restore (the service's per-slot checkpoint path) -------
    def state_dict(self) -> dict:
        """JSON-able snapshot of the full scheduler state (policy, PRNG,
        per-context statistics, trace) — what the partition service
        writes next to each slot's population so a device-loss resume
        continues the same bandit mid-flight (DESIGN.md §13/§16)."""
        return {
            "policy": self.policy,
            "seed": self.seed,
            "epsilon": self.epsilon,
            "ucb_c": self.ucb_c,
            "rng_state": self.rng.bit_generator.state,
            "stats": [[list(k), {a: list(v) for a, v in ctx.items()}]
                      for k, ctx in self.stats.items()],
            "gmax": self._gmax,
            "trace": self.trace.to_json(),
            "replay_i": self._replay_i,
        }

    @classmethod
    def from_state(cls, state: dict) -> "OperatorScheduler":
        sch = cls(seed=int(state["seed"]), policy=state["policy"],
                  epsilon=float(state["epsilon"]),
                  ucb_c=float(state["ucb_c"]))
        sch.rng.bit_generator.state = state["rng_state"]
        sch.stats = {tuple(int(x) for x in k):
                     {a: [v[0], float(v[1])] for a, v in ctx.items()}
                     for k, ctx in state["stats"]}
        sch._gmax = float(state.get("gmax", 0.0))
        sch.trace = SchedulerTrace.from_json(state["trace"])
        sch._replay_i = int(state.get("replay_i", 0))
        return sch
