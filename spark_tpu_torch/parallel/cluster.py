"""Cluster runtime: process topology, the launcher's contract, and
liveness beats.

The port of ``spark_tpu/parallel/cluster.py`` for processes that share
nothing but a filesystem.  The JAX package bootstraps a multi-controller
program through ``jax.distributed`` (a coordination service); the
cross-process plane here needs none: every process runs the same
program, knows its id and the process count from the launcher, and
exchanges data and coordination through ``HostShuffleService`` files.

- ``init_cluster`` reads the launcher's contract —
  ``SPARK_TPU_COORDINATOR``, ``SPARK_TPU_NUM_PROCESSES`` and
  ``SPARK_TPU_PROCESS_ID`` — or explicit arguments, and returns a
  ``ClusterInfo``.  It starts no service.  (The coordinator address is
  kept for the deployments that name one; nothing here connects to it.)
- ``HeartbeatMonitor`` writes ``beat_<host>.json`` into a shared
  directory every interval and reports hosts whose last beat is older
  than the timeout; the exchange barrier turns those verdicts into
  exclusions and blacklist entries (``default_host_name`` is the one
  naming rule both sides use).
- ``live_view`` is the live process set as a pure function of its
  inputs.

The JAX package's ``hybrid_mesh`` is a JAX device mesh and has no
counterpart here: the in-process mesh lane is ``parallel/mesh.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from .. import config as C

__all__ = ["ClusterInfo", "init_cluster", "default_host_name",
           "parse_host_pid", "live_view", "HeartbeatMonitor",
           "HEARTBEAT_INTERVAL", "HEARTBEAT_TIMEOUT"]

HEARTBEAT_INTERVAL = C.conf("spark.tpu.cluster.heartbeatIntervalMs").doc(
    "Milliseconds between liveness beats (spark.executor.heartbeatInterval "
    "analog)."
).int(1000)

HEARTBEAT_TIMEOUT = C.conf("spark.tpu.cluster.heartbeatTimeoutMs").doc(
    "A host whose last beat is older than this is declared dead "
    "(spark.network.timeout analog)."
).int(10000)

ENV_COORDINATOR = "SPARK_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "SPARK_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "SPARK_TPU_PROCESS_ID"


class ClusterInfo:
    """Topology of the running program: this process's id, the process
    count, the coordinator address the launcher named (or None) and the
    cards this process sees."""

    def __init__(self, process_index: int = 0, process_count: int = 1,
                 coordinator: Optional[str] = None):
        import torch
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.coordinator = coordinator
        self.local_devices = [torch.device("cuda", i) for i in
                              range(torch.cuda.device_count())] \
            if torch.cuda.is_available() else [torch.device("cpu")]

    def __repr__(self):
        return (f"ClusterInfo(process {self.process_index}/"
                f"{self.process_count}, {len(self.local_devices)} local "
                f"device(s))")


def init_cluster(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None) -> ClusterInfo:
    """This process's place in the cluster.  With no argument the
    launcher's environment contract fills them in (the JAX package's
    ``bin/spark-tpu-launch`` sets the same variables: the spark-submit →
    executor handoff without a master); what neither gives defaults to
    one process, id 0.  A process id outside ``[0, num_processes)``
    raises."""
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        coordinator_address = os.environ.get(ENV_COORDINATOR) or None
        if os.environ.get(ENV_NUM_PROCESSES):
            num_processes = int(os.environ[ENV_NUM_PROCESSES])
        if os.environ.get(ENV_PROCESS_ID):
            process_id = int(os.environ[ENV_PROCESS_ID])
    n = 1 if num_processes is None else int(num_processes)
    pid = 0 if process_id is None else int(process_id)
    if n < 1 or not 0 <= pid < n:
        raise ValueError(f"process id {pid} is outside a cluster of {n} "
                         "process(es)")
    return ClusterInfo(pid, n, coordinator_address)


def _env_process_id() -> int:
    value = os.environ.get(ENV_PROCESS_ID)
    return int(value) if value else 0


# ---------------------------------------------------------------------------
# heartbeats / failure detection
# ---------------------------------------------------------------------------

def default_host_name(process_id: Optional[int] = None) -> str:
    """Canonical host id of a process: the ONE naming rule shared by
    heartbeat beats and the exchange blacklist."""
    if process_id is None:
        process_id = _env_process_id()
    return f"host-{process_id}"


def parse_host_pid(host: str) -> Optional[int]:
    """Inverse of ``default_host_name`` where one exists: ``host-<n>``
    parses to ``n``; anything else (a ``pool-*`` serving tenant) to
    None."""
    if host.startswith("host-"):
        try:
            return int(host[len("host-"):])
        except ValueError:
            return None
    return None


def live_view(n_processes: int, dead_hosts: Sequence[str] = (),
              recovered_pids: Sequence[int] = (),
              joined_hosts: Sequence[str] = ()) -> List[int]:
    """The live process set as a PURE function of its inputs: every pid
    whose canonical host name is not in ``dead_hosts`` and that is not in
    ``recovered_pids``, with any ``joined_hosts`` beyond the static world
    added (non-canonical names are ignored)."""
    dead = set(dead_hosts)
    gone = set(recovered_pids)
    world = set(range(n_processes))
    for host in joined_hosts:
        pid = parse_host_pid(host)
        if pid is not None and pid >= 0:
            world.add(pid)
    return [p for p in sorted(world)
            if p not in gone and default_host_name(p) not in dead]


class HeartbeatMonitor:
    """File-based liveness beats over a shared directory.

    Each host writes ``beat_<host>.json`` {host, seq, ts} every interval;
    ``dead_hosts()`` reports hosts stale past the timeout, and
    ``on_failure`` callbacks fire once per newly dead host (the
    ``HeartbeatReceiver.expireDeadHosts`` analog).  ``ts`` is the clock's
    reading, ``time.monotonic`` by default: one clock for every process
    of a host."""

    def __init__(self, beat_dir: str, host_id: Optional[str] = None,
                 conf=None, clock: Callable[[], float] = time.monotonic):
        conf = conf or C.Conf()
        self.beat_dir = beat_dir
        self.host_id = host_id if host_id is not None else \
            default_host_name()
        self.interval_s = conf.get(HEARTBEAT_INTERVAL) / 1000.0
        self.timeout_s = conf.get(HEARTBEAT_TIMEOUT) / 1000.0
        self._clock = clock
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._known_dead: set = set()
        self._callbacks: List[Callable[[str], None]] = []
        os.makedirs(beat_dir, exist_ok=True)

    # -- beats --------------------------------------------------------------
    def beat(self) -> None:
        """Write one liveness beat (atomic rename, shared-fs safe)."""
        self._seq += 1
        path = os.path.join(self.beat_dir, f"beat_{self.host_id}.json")
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"host": self.host_id, "seq": self._seq,
                       "ts": self._clock()}, f)
        os.replace(tmp, path)

    def start(self) -> None:
        """Background beat thread (daemon; never on the data path)."""
        if self._thread is not None:
            return

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.beat()
                except OSError:
                    pass

        self.beat()
        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"heartbeat-{self.host_id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s)
            self._thread = None

    def retire(self) -> None:
        """Clean LEAVE, as distinct from death: stop beating and remove
        our own beat file, so observers see the host leave the world
        instead of going stale and being blacklisted."""
        self.stop()
        try:
            os.remove(os.path.join(self.beat_dir,
                                   f"beat_{self.host_id}.json"))
        except OSError:
            pass

    # -- detection ----------------------------------------------------------
    def on_failure(self, cb: Callable[[str], None]) -> None:
        self._callbacks.append(cb)

    def snapshot(self) -> Dict[str, dict]:
        out = {}
        try:
            names = os.listdir(self.beat_dir)
        except FileNotFoundError:
            return out
        for name in names:
            if not name.startswith("beat_") or not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.beat_dir, name)) as f:
                    rec = json.load(f)
                out[rec["host"]] = rec
            except (OSError, ValueError, KeyError, TypeError):
                continue        # torn write: the NEXT beat will be whole
        return out

    def live_hosts(self) -> List[str]:
        """Hosts with a FRESH beat (self included)."""
        now = self._clock()
        return sorted(host for host, rec in self.snapshot().items()
                      if now - rec["ts"] <= self.timeout_s)

    def dead_hosts(self) -> List[str]:
        """Hosts whose last beat is stale; fires callbacks for new deaths."""
        now = self._clock()
        dead = []
        for host, rec in self.snapshot().items():
            if host == self.host_id:
                continue
            if now - rec["ts"] > self.timeout_s:
                dead.append(host)
        for host in dead:
            if host not in self._known_dead:
                self._known_dead.add(host)
                for cb in self._callbacks:
                    try:
                        cb(host)
                    except Exception:
                        pass
        return sorted(dead)

    def check_or_raise(self) -> None:
        """Barrier guard: a dead peer aborts the step instead of hanging
        it."""
        dead = self.dead_hosts()
        if dead:
            raise RuntimeError(
                f"hosts {dead} missed heartbeats for > {self.timeout_s}s; "
                "aborting step (restart from last checkpoint)")
