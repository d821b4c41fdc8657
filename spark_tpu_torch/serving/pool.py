"""Elastic worker pool: admission-driven spawn and reap over the block
service.

The port of ``spark_tpu/serving/pool.py``: dynamic allocation's second
half (the ``ExecutorAllocationManager``: pending work becomes executor
requests, with hysteresis on the way down); the block service
(``parallel/blockserver.py``) is the first.  Three pieces:

* ``decide_target`` — a PURE policy: one ``DemandSignal`` snapshot in,
  one ``PoolDecision`` out.  Hysteresis (``scaleDownRounds`` low
  observations before a reap), a cooldown between resizes, min/max
  bounds, and a headroom clamp that refuses to grow into host-memory
  pressure.  No threads, no clocks of its own.

* ``WorkerPoolSupervisor`` — the serving tier's reconcile loop: sample
  the demand, run the policy, and close the gap by starting REAL worker
  processes against a shared pool root.  Workers heartbeat as
  ``pool-<wid>`` (a name ``cluster.parse_host_pid`` maps to None, so it
  never enters the exchange world's blacklist) and hold a block-service
  lease.  Statements reach workers through a filesystem spool (claim =
  atomic rename) and results come back the same way.  Each worker is a
  session on the supervisor's device with its share of the card
  (``spark.tpu.memory.hbmBudget``); a worker that finds no card raises
  and never serves on the CPU.

* Scale-down is "stop heartbeating and hand off the lease", never a
  drain barrier: the supervisor writes a reap marker, the worker finishes
  the statements it has claimed, retires its beat and exits (the
  supervisor waits out a claimed statement before its grace, where the
  JAX package's ends the worker two seconds after the marker, whatever
  it runs), and the supervisor inherits its lease
  (``BlockStore.handoff_lease``) before releasing the original, so the
  worker's sealed output stays adoptable.

``spawn_gang`` starts a list of processes, or none: if any exec fails,
every sibling already started is terminated AND waited before the error
re-raises.

    python -m spark_tpu_torch.serving.pool --worker <pool root> <wid>
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from .. import config as C
from .admission import DemandSignal

__all__ = ["PoolPolicy", "PoolDecision", "decide_target", "spawn_gang",
           "WorkerPoolSupervisor", "worker_main", "SUPERVISOR_OWNER"]

#: the supervisor's block-service identity: the heir every reaped
#: worker's lease is handed to
SUPERVISOR_OWNER = "pool-supervisor"

#: the repository root, put on a worker's PYTHONPATH so ``-m`` finds the
#: package from any working directory
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the share of the card's free memory the workers split between them
HBM_SHARE = 0.5

#: seconds a spooled statement waits for a worker's answer before the
#: server runs it itself; a reap waits as long for a claimed statement
OFFLOAD_TIMEOUT_S = 60.0

#: set in a worker's environment, it holds every K1 launch outside a
#: graph capture against the kernel's plain version and reports its K1
#: counters with each result (``chip_smoke.py``'s [pool] phase)
KERNEL_CHECK_ENV = "SPARK_TPU_POOL_KERNEL_CHECK"


# ---------------------------------------------------------------------------
# policy — pure
# ---------------------------------------------------------------------------

class PoolPolicy(NamedTuple):
    """The policy's knobs as plain values, so ``decide_target`` is a pure
    function of its arguments."""

    min_workers: int = 0
    max_workers: int = 4
    statements_per_worker: int = 2
    scale_down_rounds: int = 3
    cooldown_s: float = 2.0
    min_headroom_bytes: int = 0

    @classmethod
    def from_conf(cls, conf) -> "PoolPolicy":
        return cls(
            min_workers=int(conf.get(C.SERVER_POOL_MIN_WORKERS)),
            max_workers=int(conf.get(C.SERVER_POOL_MAX_WORKERS)),
            statements_per_worker=int(
                conf.get(C.SERVER_POOL_STATEMENTS_PER_WORKER)),
            scale_down_rounds=int(
                conf.get(C.SERVER_POOL_SCALE_DOWN_ROUNDS)),
            cooldown_s=float(conf.get(C.SERVER_POOL_COOLDOWN)),
            min_headroom_bytes=int(conf.get(C.SERVER_POOL_HEADROOM)))


class PoolDecision(NamedTuple):
    """One verdict: the target to reconcile toward, the kind of move
    ("up" | "down" | "hold"), why, and the hysteresis counter to carry
    into the next evaluation."""

    target: int
    action: str
    reason: str
    low_rounds: int = 0


def decide_target(policy: PoolPolicy, signal: DemandSignal, live: int,
                  now: float, last_scale_ts: float,
                  low_rounds: int) -> PoolDecision:
    """The target pool size from one demand snapshot.  Callers thread
    ``low_rounds`` (consecutive below-capacity observations) and
    ``last_scale_ts`` (time of the last resize) through successive calls.

    Scale-up is eager: one observation past the cooldown grows the pool
    to ``ceil(demand / statements_per_worker)``, because a queued client
    pays latency now.  Scale-down is reluctant: demand must sit below the
    pool for ``scale_down_rounds`` evaluations first, because a reaped
    worker's warm caches are gone.  The headroom clamp refuses to grow
    into host-memory pressure; min/max bound both directions."""
    desired = 0 if signal.demand <= 0 else int(
        math.ceil(signal.demand / max(1, policy.statements_per_worker)))
    desired = max(policy.min_workers, min(policy.max_workers, desired))
    if policy.min_headroom_bytes > 0 \
            and 0 <= signal.host_free < policy.min_headroom_bytes \
            and desired > live:
        return PoolDecision(
            live, "hold",
            f"headroom clamp: host_free {signal.host_free} < floor "
            f"{policy.min_headroom_bytes}", 0)
    if desired > live:
        # demand recovered: any scale-down streak is void
        if now - last_scale_ts < policy.cooldown_s:
            return PoolDecision(live, "hold", "cooldown", 0)
        return PoolDecision(
            desired, "up",
            f"demand {signal.demand} wants {desired} workers (live {live})",
            0)
    if desired < live:
        low_rounds += 1
        if low_rounds < policy.scale_down_rounds:
            return PoolDecision(
                live, "hold",
                f"hysteresis {low_rounds}/{policy.scale_down_rounds}",
                low_rounds)
        if now - last_scale_ts < policy.cooldown_s:
            return PoolDecision(live, "hold", "cooldown", low_rounds)
        return PoolDecision(
            desired, "down",
            f"demand {signal.demand} sustained below capacity "
            f"({low_rounds} rounds)", 0)
    return PoolDecision(live, "hold", "steady", 0)


# ---------------------------------------------------------------------------
# the spawn seam
# ---------------------------------------------------------------------------

def spawn_gang(cmds: List[List[str]],
               popen: Optional[Callable[..., Any]] = None,
               **popen_kwargs) -> List[Any]:
    """Start every command, or none: if any exec fails, the siblings
    already started are terminated AND waited before the error
    re-raises, so a partial gang never outlives its failure."""
    popen = popen or subprocess.Popen
    procs: List[Any] = []
    try:
        for cmd in cmds:
            procs.append(popen(cmd, **popen_kwargs))
    except BaseException:
        for pr in procs:
            try:
                pr.terminate()
            except Exception:
                pass
        for pr in procs:
            try:
                pr.wait(timeout=10)
            except Exception:
                pass
        raise
    return procs


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

def _write_json(path: str, obj: Any) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class WorkerPoolSupervisor:
    """Reconcile live worker processes against the policy's target.

    The pool root's layout::

        <root>/config.json   worker bootstrap (conf pairs, block store)
        <root>/beats/        pool-scoped heartbeats (pool-<wid> ids)
        <root>/spool/        statements: s<n>.json -> claim -> result
        <root>/reap/         reap markers (scale-down requests)
        <root>/ready/        one marker per worker with a live session
        <root>/logs/         each worker's output

    The reconcile thread samples ``demand_supplier`` every
    ``pollSeconds``, runs ``decide_target`` and closes the gap: up =
    spawn the missing workers (an exec failure counts
    ``spawn_failures`` and leaves the pool BELOW target, never a hang);
    down = reap ONE worker per tick (marker, bounded wait, lease handoff
    to the supervisor, lease release)."""

    def __init__(self, root: str, conf,
                 demand_supplier: Callable[[], DemandSignal],
                 warehouse: Optional[str] = None,
                 blockstore_root: Optional[str] = None,
                 extra_conf: Optional[Dict[str, Any]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.root = os.path.abspath(root)
        self._conf = conf
        self._demand = demand_supplier
        self._warehouse = warehouse
        self._blockstore_root = blockstore_root
        self._extra_conf = dict(extra_conf or {})
        self._clock = clock
        self.poll_s = float(conf.get(C.SERVER_POOL_POLL))
        self.owner = SUPERVISOR_OWNER
        self._workers: Dict[int, Any] = {}       # wid -> Popen
        self._logs: Dict[int, Any] = {}          # wid -> open log file
        self._spawned_at: Dict[int, float] = {}  # wid -> time.time()
        #: wid -> seconds from its spawn to its session being ready
        self.ready_s: Dict[int, float] = {}
        self._next_wid = 0
        self._next_stmt = 0
        self._low_rounds = 0
        self._last_scale_ts = -1e9
        self._last_decision: Optional[PoolDecision] = None
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._hb = None
        self._store = None
        #: the exec seam ``FaultInjector.attach_pool`` wraps
        self._popen: Callable[..., Any] = subprocess.Popen
        self.counters: Dict[str, int] = {
            "workers_spawned": 0, "workers_reaped": 0,
            "pool_target": 0, "pool_live": 0,
            "scale_decisions": 0, "spawn_failures": 0,
            "pool_statements_served": 0, "offload_fallbacks": 0,
        }
        self.last_fallback: Optional[str] = None
        #: reaps that waited for a statement their worker had claimed
        self.reap_claim_waits = 0

    # -- lifecycle -----------------------------------------------------
    def _worker_conf(self) -> Dict[str, Any]:
        """The conf pairs every worker's session starts from: what the
        supervisor's session set (the pool's own keys and its device
        memory budget aside), the caller's extras, the warehouse, the
        mesh width and device (a worker plans in the same world as the
        session it stands in for) and, on a card, an equal share of what
        is free on it as the worker's device memory budget."""
        from ..memory import HBM_BUDGET
        pairs = {k: v for k, v in self._conf._overrides.items()
                 if not k.startswith("spark.tpu.server.pool.")
                 and k != HBM_BUDGET.key}
        pairs.update(self._extra_conf)
        if self._warehouse is not None:
            pairs.setdefault(C.WAREHOUSE_DIR.key, self._warehouse)
        pairs.setdefault(C.MESH_SHARDS.key,
                         str(self._conf.get(C.MESH_SHARDS)))
        device = str(self._conf.get(C.TORCH_DEVICE))
        pairs.setdefault(C.TORCH_DEVICE.key, device)
        if device.startswith("cuda") and HBM_BUDGET.key not in pairs:
            import torch
            free, _total = torch.cuda.mem_get_info()
            n = max(1, int(self._conf.get(C.SERVER_POOL_MAX_WORKERS)))
            pairs[HBM_BUDGET.key] = str(int(free * HBM_SHARE) // n)
        return pairs

    def start(self, reconcile: bool = True) -> None:
        """Lay out the pool root and begin supervising.  With
        ``reconcile=False`` no background loop starts: the caller drives
        ``tick()``."""
        if self._thread is not None:
            return
        for sub in ("beats", "spool", "reap", "ready", "logs"):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)
        _write_json(os.path.join(self.root, "config.json"), {
            "conf": self._worker_conf(),
            "blockstore_root": self._blockstore_root,
            "supervisor_pid": os.getpid(),
            "poll_s": self.poll_s,
        })
        from ..parallel.cluster import HeartbeatMonitor
        self._hb = HeartbeatMonitor(
            os.path.join(self.root, "beats"), host_id=self.owner,
            conf=self._conf)
        self._hb.start()
        if self._blockstore_root:
            from ..parallel.blockserver import BlockStore
            self._store = BlockStore(self._blockstore_root, self._conf)
            self._touch_own_lease()
        self._stop_evt.clear()
        if reconcile:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="pool-supervisor")
            self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
        for wid in self.live_wids():
            self._reap(wid)
        if self._hb is not None:
            self._hb.retire()
            self._hb = None

    @property
    def live(self) -> int:
        with self._lock:
            return len(self._workers)

    def live_wids(self) -> List[int]:
        with self._lock:
            return sorted(self._workers)

    # -- reconcile loop ------------------------------------------------
    def _loop(self) -> None:
        while not self._stop_evt.wait(self.poll_s):
            try:
                self.tick()
            except Exception:
                # the supervisor outlives a bad tick; the next one
                # samples from scratch
                pass

    def tick(self) -> PoolDecision:
        """One reconcile step (public so callers can drive the loop
        deterministically)."""
        self._collect_exited()
        self._collect_ready()
        self._touch_own_lease()
        signal = self._demand()
        now = self._clock()
        decision = decide_target(
            PoolPolicy.from_conf(self._conf), signal, self.live,
            now, self._last_scale_ts, self._low_rounds)
        self._low_rounds = decision.low_rounds
        self._last_decision = decision
        self.counters["pool_target"] = decision.target
        if decision.action == "up":
            self.counters["scale_decisions"] += 1
            self._last_scale_ts = now
            self._scale_up(decision.target)
        elif decision.action == "down":
            self.counters["scale_decisions"] += 1
            self._last_scale_ts = now
            with self._lock:
                doomed = max(self._workers) if self._workers else None
            if doomed is not None and self.live > decision.target:
                self._reap(doomed)
        self.counters["pool_live"] = self.live
        return decision

    def _collect_exited(self) -> None:
        with self._lock:
            gone = [w for w, pr in self._workers.items()
                    if pr.poll() is not None]
            for w in gone:
                del self._workers[w]
                log = self._logs.pop(w, None)
                if log is not None:
                    log.close()

    def _collect_ready(self) -> None:
        with self._lock:
            waiting = [w for w in self._spawned_at if w not in self.ready_s]
        for w in waiting:
            rec = _read_json(os.path.join(self.root, "ready", str(w)))
            if rec is not None:
                self.ready_s[w] = float(rec["ts"]) - self._spawned_at[w]

    def _touch_own_lease(self) -> None:
        if self._store is not None:
            try:
                self._store.touch_lease(self.owner)
            except Exception:
                pass

    # -- spawn / reap --------------------------------------------------
    def _worker_cmd(self, wid: int) -> List[str]:
        return [sys.executable, "-m", "spark_tpu_torch.serving.pool",
                "--worker", self.root, str(wid)]

    def _worker_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        # a fault plan aimed at the SERVER must not replay in its workers
        env.pop("SPARK_TPU_FAULT_PLAN", None)
        env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
        return env

    def _scale_up(self, target: int) -> None:
        want = target - self.live
        env = self._worker_env()
        for _ in range(max(0, want)):
            with self._lock:
                wid = self._next_wid
                self._next_wid += 1
            # the worker's output goes to a file: an unread pipe would
            # block it at its next write
            log = open(os.path.join(self.root, "logs", f"w{wid}.txt"), "w")
            try:
                t_spawn = time.time()
                pr = self._popen(self._worker_cmd(wid), env=env,
                                 stdout=log, stderr=subprocess.STDOUT)
            except Exception:
                # convergence below target: count it, leave the pool
                # where it is, let the next tick decide again
                log.close()
                self.counters["spawn_failures"] += 1
                continue
            with self._lock:
                self._workers[wid] = pr
                self._logs[wid] = log
                self._spawned_at[wid] = t_spawn
            self.counters["workers_spawned"] += 1

    def _reap(self, wid: int) -> None:
        """Scale one worker down: marker, bounded wait, lease handoff,
        lease release.  No drain barrier: in-flight sealed output stays
        adoptable through the heir lease."""
        with self._lock:
            pr = self._workers.get(wid)
        if pr is None:
            return
        marker = os.path.join(self.root, "reap", str(wid))
        try:
            with open(marker, "w") as f:
                f.write("reap")
        except OSError:
            pass
        # the worker reads its marker only between statements: one it has
        # claimed runs to its end (bounded by the offload timeout) before
        # the grace starts, the worker still counted live for the client
        # waiting on it, or that client would wait out the timeout and
        # then run the statement again in the server
        deadline = time.time() + OFFLOAD_TIMEOUT_S
        waited = False
        while pr.poll() is None and self._holds_claim(wid) \
                and time.time() < deadline:
            waited = True
            time.sleep(0.02)
        self.reap_claim_waits += waited
        with self._lock:
            self._workers.pop(wid, None)
            log = self._logs.pop(wid, None)
        deadline = time.time() + max(2.0, 8 * self.poll_s)
        while pr.poll() is None and time.time() < deadline:
            time.sleep(0.02)
        if pr.poll() is None:
            try:
                pr.terminate()
                pr.wait(timeout=5)
            except Exception:
                pass
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        if log is not None:
            log.close()
        # scale-down safety: the worker's sealed output must stay
        # adoptable BEFORE its lease may expire
        if self._store is not None:
            try:
                self._store.handoff_lease(f"pool-{wid}", self.owner)
                self._store.release_lease(f"pool-{wid}")
            except Exception:
                pass
        try:
            os.remove(marker)
        except OSError:
            pass
        self.counters["workers_reaped"] += 1

    def _holds_claim(self, wid: int) -> bool:
        """Whether worker ``wid`` holds a claimed, unanswered statement."""
        try:
            names = os.listdir(os.path.join(self.root, "spool"))
        except OSError:
            return False
        return any(n.endswith(f".claim{wid}") for n in names)

    # -- statement offload ---------------------------------------------
    def execute(self, sql: str,
                timeout_s: float = OFFLOAD_TIMEOUT_S) -> Optional[dict]:
        """Offer one statement to the pool through the spool; returns the
        server-shaped result dict, or None when no worker answered in
        time or the worker failed (the caller then runs it itself)."""
        if self.live <= 0:
            self._fallback("no live worker")
            return None
        with self._lock:
            sid = self._next_stmt
            self._next_stmt += 1
        base = os.path.join(self.root, "spool", f"s{sid:06d}")
        _write_json(base + ".json", {"sql": sql})
        result_path = base + ".result.json"
        deadline = time.time() + timeout_s
        try:
            while time.time() < deadline:
                # sampled before the read: a worker answers before it
                # leaves the live set, so its last answer is not missed
                gone = self.live <= 0
                rec = _read_json(result_path)
                if rec is not None:
                    if rec.get("ok"):
                        with self._lock:
                            self.counters["pool_statements_served"] += 1
                        return rec["result"]
                    self._fallback(f"worker error: {rec.get('error')}")
                    return None
                if gone:
                    break           # every worker died while we waited
                time.sleep(0.01)
            # withdraw the offer if nobody claimed it (a claimed SELECT may
            # still finish; its result is simply never read)
            try:
                os.remove(base + ".json")
            except OSError:
                pass
            self._fallback("no worker answered within "
                           f"{timeout_s:.0f} s" if self.live > 0
                           else "every worker died while it waited")
            return None
        finally:
            try:
                os.remove(result_path)
            except OSError:
                pass

    # -- observability -------------------------------------------------
    def _fallback(self, why: str) -> None:
        """Count a statement the pool hands back to the server, and keep
        why (``stats()["lastFallback"]``)."""
        with self._lock:
            self.counters["offload_fallbacks"] += 1
            self.last_fallback = why[:2000]

    def stats(self) -> Dict[str, Any]:
        self._collect_ready()
        d = self._last_decision
        out: Dict[str, Any] = {
            "live": self.live, "workers": self.live_wids(),
            "counters": dict(self.counters),
            "readyMs": {str(w): round(s * 1e3, 1)
                        for w, s in sorted(self.ready_s.items())},
        }
        if d is not None:
            out["lastDecision"] = {"target": d.target, "action": d.action,
                                   "reason": d.reason}
        if self.last_fallback is not None:
            out["lastFallback"] = self.last_fallback
        if self.reap_claim_waits:
            out["reapClaimWaits"] = self.reap_claim_waits
        return out


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

def _json_safe(v: Any):
    # the server's _json_safe (a worker does not import the HTTP layer):
    # results cross the spool as strict JSON
    if isinstance(v, float):
        if v != v:
            return None
        if v in (float("inf"), float("-inf")):
            return str(v)
        return v
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if hasattr(v, "item"):
        return _json_safe(v.item())
    return str(v)


def _claim_statements(spool: str, wid: int) -> List[str]:
    """Claim every unclaimed statement by atomic rename: of two workers
    racing on one file, exactly one rename succeeds."""
    claimed = []
    try:
        names = sorted(os.listdir(spool))
    except OSError:
        return claimed
    for name in names:
        if not name.endswith(".json") or ".claim" in name \
                or name.endswith(".result.json"):
            continue
        src = os.path.join(spool, name)
        dst = f"{src}.claim{wid}"
        try:
            os.rename(src, dst)
        except OSError:
            continue                      # a sibling won the race
        claimed.append(dst)
    return claimed


def _kernel_report() -> Dict[str, Any]:
    """This worker's K1 wrapper launches so far (``cuda_agg``)."""
    from .. import cuda_agg
    return {"launches": dict(cuda_agg.ENTRY_LAUNCHES),
            "captured": dict(cuda_agg.CAPTURED_LAUNCHES)}


def worker_main(root: str, wid: int) -> int:
    """One elastic pool worker: a session on the supervisor's device (a
    missing card raises), a ``pool-<wid>`` heartbeat and block-service
    lease, serving spooled statements against the server's warehouse
    (persistent tables travel through the filesystem catalog); exits on
    its reap marker (clean retire) or when the supervisor disappears.
    With ``SPARK_TPU_POOL_KERNEL_CHECK`` set, every K1 launch outside a
    graph capture is held against its plain version and each result
    carries the worker's K1 counters."""
    root = os.path.abspath(root)
    cfg = None
    for _ in range(100):                  # config.json lands before spawn
        cfg = _read_json(os.path.join(root, "config.json"))
        if cfg is not None:
            break
        time.sleep(0.05)
    if cfg is None:
        return 41
    from ..sql.session import SparkSession
    session = SparkSession(C.Conf(dict(cfg.get("conf") or {})))
    conf = session.conf_obj
    if session.device.type == "cpu":
        import torch
        torch.set_num_threads(1)      # workers share the host's cores
    poll_s = float(cfg.get("poll_s") or 0.25)
    check = None
    if os.environ.get(KERNEL_CHECK_ENV):
        from ..testing import _K1Compare
        check = _K1Compare().__enter__()

    from ..parallel.cluster import HeartbeatMonitor
    hb = HeartbeatMonitor(os.path.join(root, "beats"),
                          host_id=f"pool-{wid}", conf=conf)
    hb.start()
    store = None
    if cfg.get("blockstore_root"):
        from ..parallel.blockserver import BlockStore
        try:
            store = BlockStore(cfg["blockstore_root"], conf)
            store.touch_lease(f"pool-{wid}")
        except Exception:
            store = None
    os.makedirs(os.path.join(root, "ready"), exist_ok=True)
    _write_json(os.path.join(root, "ready", str(wid)),
                {"ts": time.time(), "device": str(session.device)})

    spool = os.path.join(root, "spool")
    reap_marker = os.path.join(root, "reap", str(wid))
    sup_beat = os.path.join(root, "beats", f"beat_{SUPERVISOR_OWNER}.json")
    try:
        while True:
            if os.path.exists(reap_marker):
                return 0                  # clean retire
            rec = _read_json(sup_beat)
            if rec is None:
                return 0                  # supervisor retired: orphaned
            if time.monotonic() - float(rec.get("ts", 0)) \
                    > 4 * hb.timeout_s:
                return 0                  # supervisor hung or killed
            for claim in _claim_statements(spool, wid):
                stmt = _read_json(claim) or {}
                base = claim.split(".json.claim")[0]
                t0 = time.time()
                try:
                    df = session.sql(str(stmt.get("sql", "")))
                    columns = list(df.schema.names)
                    rows = [[_json_safe(v) for v in r]
                            for r in df.collect()]
                    result = {
                        "columns": columns, "rows": rows,
                        "rowCount": len(rows),
                        "durationMs": round((time.time() - t0) * 1000, 1),
                        "pooled": True, "poolWorker": wid}
                    if check is not None:
                        result["kernels"] = dict(
                            _kernel_report(), checked=check.checked,
                            equal=check.equal,
                            max_abs_err=check.max_abs_err)
                    out = {"ok": True, "result": result}
                except Exception as e:  # noqa: BLE001 — spooled back
                    out = {"ok": False,
                           "error": f"{type(e).__name__}: {e}"[:2000]}
                _write_json(base + ".result.json", out)
                try:
                    os.remove(claim)
                except OSError:
                    pass
                if store is not None:
                    try:
                        store.touch_lease(f"pool-{wid}")
                    except Exception:
                        pass
            time.sleep(poll_s / 2)
    finally:
        hb.retire()


def main(argv: List[str]) -> int:
    if len(argv) >= 3 and argv[0] == "--worker":
        return worker_main(argv[1], int(argv[2]))
    print("usage: python -m spark_tpu_torch.serving.pool --worker "
          "<root> <wid>", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
