"""Discrete-event cluster simulator, the §5.2 methodology: the port's own
copy of ``repro.cluster.simulator``.

Replays a spot obtainability trace against a policy: at each control tick,

1. **trace transitions**: if a zone's spot capacity drops below the number
   of active spot instances, the excess instances are preempted (newest
   first).  Policies receive best-effort preemption warnings ahead when the
   trace already shows the upcoming drop (real clouds warn 30-120 s;
   delivery is probabilistic, §2.3).
2. **instance FSM steps**: provisioning instances become ready after the
   cold start delay ``d``; policies get ``on_ready`` (Alg. 1 HANDLE-LAUNCH).
3. **policy tick**: ``policy.decide(obs)`` returns launch/terminate
   actions.  Spot launches succeed iff the zone has remaining capacity;
   a failed launch fires ``on_launch_failure`` and costs nothing.
4. **metrics**: availability (ready >= N_Tar), ready-count time series and
   per-second billing (including the provisioning period, §2.3).

The draws (warning delivery) come from ``np.random.default_rng(seed)`` in
the reference's order, so every result is the reference's to the bit.  Each
transition is also tapped into the run's observability recorder at the
reference's points (policy decisions with their reasons, lifecycle,
warnings, launch failures, the autoscaler target); the taps draw nothing
and change no result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.catalog import Catalog, Zone, default_catalog
from repro_torch.cluster.instance import Instance, InstanceKind, InstanceState
from repro_torch.cluster.traces import SpotTrace
from repro_torch.core.autoscaler import Autoscaler, ConstantTarget
from repro_torch.core.policy import (
    ControllerEvent,
    EventKind,
    LaunchOnDemand,
    LaunchSpot,
    Observation,
    Policy,
    Terminate,
)
from repro_torch.obs.events import (
    AutoscalerTargetEvent,
    LaunchFailureEvent,
    PolicyDecisionEvent,
    PreemptionWarningEvent,
    ReplicaLifecycleEvent,
)
from repro_torch.obs.recorder import ObsRecorder


@dataclasses.dataclass
class SimConfig:
    itype: str = "p3.2xlarge"
    cold_start_s: float = 183.0      # §2.3: measured Llama-2-7B/vLLM deploy
    control_interval_s: float = 30.0
    warning_enabled: bool = True
    seed: int = 0
    # terminate-before-preempt grace: when a warning arrives, policies may
    # proactively launch; the simulator itself takes no action.
    record_series: bool = True


@dataclasses.dataclass
class SimResult:
    """Aggregated metrics of one simulated run."""

    policy: str
    trace: str
    duration_s: float
    availability: float              # fraction of ticks with ready >= N_Tar
    total_cost: float                # $ (absolute, catalog prices)
    spot_cost: float
    od_cost: float
    cost_vs_ondemand: float          # total cost / cost of N_Tar OD replicas
    n_preemptions: int
    n_launch_failures: int
    n_spot_launches: int
    n_od_launches: int
    # time series sampled each tick (empty when record_series=False)
    t: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0)
    )
    ready_spot: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=int)
    )
    ready_od: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=int)
    )
    n_target_series: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=int)
    )

    def summary(self) -> str:
        return (
            f"{self.policy:>16s} @ {self.trace:<8s} "
            f"avail={self.availability:6.2%} "
            f"cost={self.cost_vs_ondemand:6.2%} of OD "
            f"preempt={self.n_preemptions:4d} "
            f"launch_fail={self.n_launch_failures:4d}"
        )


class ClusterSimulator:
    """Run one policy against one trace."""

    def __init__(
        self,
        trace: SpotTrace,
        policy: Policy,
        *,
        catalog: Optional[Catalog] = None,
        autoscaler: Optional[Autoscaler] = None,
        config: Optional[SimConfig] = None,
        zones: Optional[Sequence[str]] = None,
        # hook called each tick AFTER state transitions, BEFORE policy
        # decisions — the serving simulator uses it to pump requests.
        tick_hook: Optional[Callable[[float, "ClusterSimulator"], None]] = None,
        # the run's recorder; every engine taps the control plane here, so
        # their event streams are byte-identical (a bare run records nothing)
        obs: Optional[ObsRecorder] = None,
    ) -> None:
        self.trace = trace
        self.policy = policy
        self.catalog = catalog or default_catalog()
        self.autoscaler = autoscaler or ConstantTarget(4)
        self.config = config or SimConfig()
        self.rng = np.random.default_rng(self.config.seed)
        self.tick_hook = tick_hook
        self.obs = obs if obs is not None else ObsRecorder(detail="off")

        zone_names = list(zones) if zones is not None else list(trace.zones)
        missing = [z for z in zone_names if z not in trace.zones]
        if missing:
            raise ValueError(f"zones {missing} not present in trace")
        self.zones: List[Zone] = [self.catalog.zone(z) for z in zone_names]
        self.zone_names = zone_names

        self.instances: List[Instance] = []   # active only (dead pruned)
        self._dead_spot_cost = 0.0
        self._dead_od_cost = 0.0
        self.now = 0.0
        self.n_preemptions = 0
        self.n_launch_failures = 0
        self.n_spot_launches = 0
        self.n_od_launches = 0
        self._series_t: List[float] = []
        self._series_rs: List[int] = []
        self._series_ro: List[int] = []
        self._series_nt: List[int] = []
        self._warn_info: Optional[Dict[str, Tuple[float, float]]] = None
        # dense per-tick views precomputed by run() (pure perf: bit-exact
        # with the scalar trace accessors, see SpotTrace.dense_ticks)
        self._zcol: Dict[str, int] = {
            z: j for j, z in enumerate(zone_names)
        }
        self._tick_rows: Optional[List[List[int]]] = None
        self._warn_cols: Optional[List[List[int]]] = None
        self._k: Optional[int] = None
        self._preempt_listeners: List[Callable[[Instance, float], None]] = []
        self._terminate_listeners: List[Callable[[Instance, float], None]] = []
        self._ready_listeners: List[Callable[[Instance, float], None]] = []
        #: structured transition log (kept when record_series is on; the
        #: serving facade surfaces it through Service.status()).
        self.events: List[ControllerEvent] = []

        self.policy.reset(self.zones, self.catalog, self.config.itype)

    # -- event delivery ---------------------------------------------------
    def _emit(
        self,
        kind: EventKind,
        zone: str,
        instance_id: Optional[int] = None,
    ) -> ControllerEvent:
        """Deliver one structured transition to the policy (and log it)."""
        event = ControllerEvent(
            kind=kind, zone=zone, now=self.now, instance_id=instance_id
        )
        if self.config.record_series:
            self.events.append(event)
        self.policy.on_event(event)
        return event

    # -- listener registration (serving layer) --------------------------
    def add_preempt_listener(
        self, fn: Callable[[Instance, float], None]
    ) -> None:
        self._preempt_listeners.append(fn)

    def add_terminate_listener(
        self, fn: Callable[[Instance, float], None]
    ) -> None:
        """Called when the policy/autoscaler terminates an instance.

        Terminated instances are retired from ``self.instances``
        immediately, so without this hook the serving layer would never
        observe the death and its replica would keep serving as a zombie.
        """
        self._terminate_listeners.append(fn)

    def add_ready_listener(
        self, fn: Callable[[Instance, float], None]
    ) -> None:
        self._ready_listeners.append(fn)

    # -- state views -----------------------------------------------------
    def active_spot(self, zone: Optional[str] = None) -> List[Instance]:
        return [
            i
            for i in self.instances
            if i.is_spot()
            and i.is_active()
            and (zone is None or i.zone == zone)
        ]

    def ready_instances(self) -> List[Instance]:
        return [i for i in self.instances if i.is_ready()]

    def _observation(self, n_target: int) -> Observation:
        spot_ready, spot_prov, od_ready, od_prov = [], [], [], []
        for i in self.instances:
            if not i.is_active():
                continue
            if i.is_spot():
                (spot_ready if i.is_ready() else spot_prov).append(i)
            else:
                (od_ready if i.is_ready() else od_prov).append(i)
        return Observation(
            now=self.now,
            n_target=n_target,
            spot_ready=spot_ready,
            spot_provisioning=spot_prov,
            od_ready=od_ready,
            od_provisioning=od_prov,
        )

    # -- mechanics -------------------------------------------------------
    def _launch(self, kind: InstanceKind, zone_name: str) -> Optional[Instance]:
        zone = self.catalog.zone(zone_name)
        if kind is InstanceKind.SPOT:
            if self._tick_rows is not None and self._k is not None \
                    and zone_name in self._zcol:
                cap = self._tick_rows[self._k][self._zcol[zone_name]]
            else:
                cap = self.trace.capacity(zone_name, self.now)
            in_use = len(self.active_spot(zone_name))
            if in_use + 1 > cap:
                self.n_launch_failures += 1
                self._emit(EventKind.LAUNCH_FAILURE, zone_name)
                if self.obs.enabled:
                    self.obs.emit(LaunchFailureEvent(
                        t=self.now, zone=zone_name, kind="spot"))
                return None
            price = self.catalog.spot_price(self.config.itype, zone_name)
            self.n_spot_launches += 1
        else:
            # On-demand is modelled as always obtainable (§5.1 Discussion:
            # "on-demand instances are typically obtainable across regions").
            price = self.catalog.od_price(self.config.itype, zone_name)
            self.n_od_launches += 1
        inst = Instance(
            zone=zone_name,
            region=zone.region,
            cloud=zone.cloud,
            kind=kind,
            itype=self.config.itype,
            hourly_price=price,
            launched_at=self.now,
            cold_start_s=self.config.cold_start_s,
        )
        self.instances.append(inst)
        if self.obs.enabled:
            self.obs.emit(ReplicaLifecycleEvent(
                t=self.now,
                phase="provision",
                instance_id=self.obs.replica_ordinal(inst.id),
                zone=zone_name,
                kind="spot" if kind is InstanceKind.SPOT else "ondemand",
                hourly_price=price,
            ))
        return inst

    def _apply_trace(self, k: Optional[int] = None) -> None:
        """Preempt spot instances in zones whose capacity dropped."""
        if k is not None and self._tick_rows is not None:
            row = self._tick_rows[k]
        else:
            d = self.trace.capacity_row(self.now)
            row = [d[z] for z in self.zone_names]
        # one pass over instances instead of one scan per zone; zones
        # without active spot can never have excess > 0, so skip them
        by_zone: Dict[str, List[Instance]] = {}
        zcol = self._zcol
        for i in self.instances:
            if i.is_spot() and i.is_active() and i.zone in zcol:
                by_zone.setdefault(i.zone, []).append(i)
        if not by_zone:
            return
        for zone_name, active in (
            (z, by_zone.get(z)) for z in self.zone_names
        ):
            if not active:
                continue
            excess = len(active) - row[zcol[zone_name]]
            if excess <= 0:
                continue
            # newest first: fresh instances are evicted first in a crunch
            active.sort(key=lambda i: -i.launched_at)
            for inst in active[:excess]:
                inst.preempt(self.now)
                self.n_preemptions += 1
                self._emit(EventKind.PREEMPTION, zone_name, inst.id)
                # the listeners may record the grace window's migration
                # events, so the "dead" record comes after them
                for fn in self._preempt_listeners:
                    fn(inst, self.now)
                if self.obs.enabled:
                    self.obs.emit(ReplicaLifecycleEvent(
                        t=self.now,
                        phase="dead",
                        instance_id=self.obs.replica_ordinal(inst.id),
                        zone=zone_name,
                        cause="preemption",
                    ))
                self._retire(inst)

    def _resolve_warn_info(self) -> Dict[str, Tuple[float, float]]:
        if self._warn_info is None:
            # zone -> (warning lead, delivery prob), resolved once; a trace
            # may carry its own observed lead, overriding the cloud default
            self._warn_info = {
                z: (
                    max(
                        (
                            self.trace.preemption_warning_s
                            if self.trace.preemption_warning_s is not None
                            else self.catalog.cloud(
                                self.catalog.zone(z).cloud
                            ).preemption_warning_s
                        ),
                        self.trace.dt,
                    ),
                    self.catalog.cloud(
                        self.catalog.zone(z).cloud
                    ).warning_delivery_prob,
                )
                for z in self.zone_names
            }
        return self._warn_info

    def _deliver_warnings(self, k: Optional[int] = None) -> None:
        """Best-effort preemption warnings (§2.3): look ahead by the cloud's
        advertised warning lead (120 s AWS, 30 s GCP/Azure); if capacity will
        drop, warn (probabilistically — warnings are best-effort)."""
        if not self.config.warning_enabled:
            return
        warn_info = self._resolve_warn_info()
        if k is not None and self._warn_cols is not None:
            # precomputed path: same drops, same guard, and crucially the
            # same rng draw count/order (one draw per dropping zone, in
            # zone_names order) as the scalar path below
            cols = self._warn_cols[k]
            if not cols:
                return
            for j in cols:
                zone_name = self.zone_names[j]
                if self.rng.random() < warn_info[zone_name][1]:
                    for inst in self.active_spot(zone_name):
                        if inst.warned_at is None:
                            inst.warned_at = self.now
                    self._emit(EventKind.WARNING, zone_name)
                    if self.obs.enabled:
                        self.obs.emit(PreemptionWarningEvent(
                            t=self.now, zone=zone_name))
            return
        now_row = self.trace.capacity_row(self.now)
        for zone_name in self.zone_names:
            lead, prob = warn_info[zone_name]
            horizon = self.now + lead
            if horizon >= self.trace.duration_s:
                continue
            if self.trace.capacity(zone_name, horizon) < now_row[zone_name]:
                if self.rng.random() < prob:
                    for inst in self.active_spot(zone_name):
                        if inst.warned_at is None:
                            inst.warned_at = self.now
                    self._emit(EventKind.WARNING, zone_name)
                    if self.obs.enabled:
                        self.obs.emit(PreemptionWarningEvent(
                            t=self.now, zone=zone_name))

    def _retire(self, inst: Instance) -> None:
        """Move a dead instance out of the scan list; bank its cost."""
        cost = inst.cost(self.now)
        if inst.is_spot():
            self._dead_spot_cost += cost
        else:
            self._dead_od_cost += cost
        try:
            self.instances.remove(inst)
        except ValueError:  # pragma: no cover - already pruned
            pass

    def _step_instances(self) -> None:
        for inst in self.instances:
            if inst.state is InstanceState.PROVISIONING:
                was_ready = inst.is_ready()
                inst.step_to(self.now)
                if inst.is_ready() and not was_ready:
                    if inst.is_spot():
                        self._emit(EventKind.READY, inst.zone, inst.id)
                    if self.obs.enabled:
                        self.obs.emit(ReplicaLifecycleEvent(
                            t=self.now,
                            phase="ready",
                            instance_id=self.obs.replica_ordinal(inst.id),
                            zone=inst.zone,
                        ))
                    for fn in self._ready_listeners:
                        fn(inst, self.now)

    def _execute(self, actions) -> None:
        by_id = {i.id: i for i in self.instances}
        # the policy's reasons pair with the actions by index (a policy
        # that notes nothing yields an empty list: every reason None)
        reasons = self.policy.take_reasons()
        rec = self.obs
        for idx, act in enumerate(actions):
            reason = reasons[idx] if idx < len(reasons) else None
            if isinstance(act, (LaunchSpot, LaunchOnDemand)):
                spot = isinstance(act, LaunchSpot)
                inst = self._launch(
                    InstanceKind.SPOT if spot else InstanceKind.ON_DEMAND,
                    act.zone)
                if rec.enabled:
                    rec.emit(PolicyDecisionEvent(
                        t=self.now,
                        action="launch_spot" if spot else "launch_ondemand",
                        zone=act.zone,
                        instance_id=(None if inst is None
                                     else rec.replica_ordinal(inst.id)),
                        reason=reason,
                    ))
            elif isinstance(act, Terminate):
                inst = by_id.get(act.instance_id)
                if rec.enabled:
                    rec.emit(PolicyDecisionEvent(
                        t=self.now,
                        action="terminate",
                        zone=None if inst is None else inst.zone,
                        instance_id=rec.replica_ordinal(act.instance_id),
                        reason=reason,
                    ))
                if inst is not None and inst.is_active():
                    inst.terminate(self.now)
                    if rec.enabled:
                        rec.emit(ReplicaLifecycleEvent(
                            t=self.now,
                            phase="dead",
                            instance_id=rec.replica_ordinal(inst.id),
                            zone=inst.zone,
                            cause="terminate",
                        ))
                    for fn in self._terminate_listeners:
                        fn(inst, self.now)
                    self._retire(inst)
            else:  # pragma: no cover - defensive
                raise TypeError(f"unknown action {act!r}")

    def _precompute(self, dt: float, ticks: int) -> None:
        """Dense per-tick trace views for the run loop.

        Bit-exact with the scalar accessors (same clamped indexing, same
        float arithmetic — see :meth:`SpotTrace.dense_ticks`); replaces
        the per-tick ``capacity_row`` dict builds and lookahead
        ``capacity`` calls that dominated the control-plane profile.
        """
        tr = self.trace
        cap = tr.dense_ticks(dt, ticks, self.zone_names)
        self._tick_rows = cap.tolist()
        if self.config.warning_enabled:
            warn_info = self._resolve_warn_info()
            t = np.arange(ticks, dtype=np.float64) * dt
            drop = np.zeros((ticks, len(self.zone_names)), dtype=bool)
            for j, z in enumerate(self.zone_names):
                lead = warn_info[z][0]
                ahead = tr.dense_ticks(dt, ticks, [z], offset_s=lead)[:, 0]
                drop[:, j] = (ahead < cap[:, j]) & (t + lead < tr.duration_s)
            self._warn_cols = [np.flatnonzero(r).tolist() for r in drop]

    # -- main loop ---------------------------------------------------------
    def run(self, duration_s: Optional[float] = None) -> SimResult:
        dur = float(duration_s or self.trace.duration_s)
        dt = self.config.control_interval_s
        ticks = int(dur / dt)
        ok_ticks = 0
        self._precompute(dt, ticks)

        prev_target: Optional[int] = None
        for k in range(ticks):
            self.now = k * dt
            self._k = k
            self._apply_trace(k)
            self._step_instances()
            self._deliver_warnings(k)
            if self.tick_hook is not None:
                self.tick_hook(self.now, self)
            n_target = self.autoscaler.target(self.now)
            if self.obs.enabled and n_target != prev_target:
                self.obs.emit(AutoscalerTargetEvent(
                    t=self.now, target=n_target, prev_target=prev_target))
            prev_target = n_target
            obs = self._observation(n_target)
            self._execute(self.policy.decide(obs))
            # metrics AFTER actions so cold starts are charged immediately
            n_ready_spot = n_ready_od = 0
            for i in self.instances:
                if i.state is InstanceState.READY:
                    if i.kind is InstanceKind.SPOT:
                        n_ready_spot += 1
                    else:
                        n_ready_od += 1
            if n_ready_spot + n_ready_od >= n_target:
                ok_ticks += 1
            if self.config.record_series:
                self._series_t.append(self.now)
                self._series_rs.append(n_ready_spot)
                self._series_ro.append(n_ready_od)
                self._series_nt.append(n_target)

        self.now = ticks * dt
        return self._result(dur, ok_ticks, ticks)

    # -- results ----------------------------------------------------------
    def _result(self, dur: float, ok_ticks: int, ticks: int) -> SimResult:
        spot_cost = self._dead_spot_cost + sum(
            i.cost(self.now) for i in self.instances if i.is_spot()
        )
        od_cost = self._dead_od_cost + sum(
            i.cost(self.now) for i in self.instances if not i.is_spot()
        )
        # denominator: keeping N_Tar on-demand replicas in the cheapest zone
        # for the whole run (the paper's "relative to OD" normalization).
        od_zone = min(
            self.zone_names,
            key=lambda z: self.catalog.od_price(self.config.itype, z),
        )
        mean_target = (
            float(np.mean(self._series_nt))
            if self._series_nt
            else float(self.autoscaler.target(0.0))
        )
        od_ref = (
            self.catalog.od_price(self.config.itype, od_zone)
            * mean_target
            * dur
            / 3600.0
        )
        return SimResult(
            policy=self.policy.name,
            trace=self.trace.name,
            duration_s=dur,
            availability=ok_ticks / max(ticks, 1),
            total_cost=spot_cost + od_cost,
            spot_cost=spot_cost,
            od_cost=od_cost,
            cost_vs_ondemand=(spot_cost + od_cost) / max(od_ref, 1e-9),
            n_preemptions=self.n_preemptions,
            n_launch_failures=self.n_launch_failures,
            n_spot_launches=self.n_spot_launches,
            n_od_launches=self.n_od_launches,
            t=np.asarray(self._series_t),
            ready_spot=np.asarray(self._series_rs, dtype=int),
            ready_od=np.asarray(self._series_ro, dtype=int),
            n_target_series=np.asarray(self._series_nt, dtype=int),
        )


def run_policy_on_trace(
    policy_name: str,
    trace: SpotTrace,
    *,
    n_target: int = 4,
    itype: str = "p3.2xlarge",
    cold_start_s: float = 183.0,
    control_interval_s: float = 30.0,
    duration_s: Optional[float] = None,
    seed: int = 0,
    policy_kwargs: Optional[dict] = None,
) -> SimResult:
    """Convenience one-shot runner used by benchmarks and tests; the
    Omniscient oracle gets its schedule solved on ``trace`` first."""
    from repro_torch.core.policy import make_policy

    policy = make_policy(policy_name, **(policy_kwargs or {}))
    if policy_name == "omniscient":
        from repro_torch.core.omniscient import solve_omniscient

        cat = default_catalog()
        k = (cat.od_price(itype, trace.zones[0])
             / cat.spot_price(itype, trace.zones[0]))
        policy.attach_schedule(solve_omniscient(
            trace, n_target=n_target, cold_start_s=cold_start_s, k_ratio=k,
            avail_target=0.99))
    sim = ClusterSimulator(
        trace,
        policy,
        autoscaler=ConstantTarget(n_target),
        config=SimConfig(
            itype=itype,
            cold_start_s=cold_start_s,
            control_interval_s=control_interval_s,
            seed=seed,
        ),
    )
    return sim.run(duration_s)
