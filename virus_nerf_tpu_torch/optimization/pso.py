"""Particle swarm optimization over hyper-parameter space.

The port's copy of ``virus_nerf_tpu/optimization/pso.py`` (numpy only):
the same algorithm, random draws, state-JSON schema and
``pso_history.csv`` columns, so a swarm saved by one package resumes in
the other.  Counterpart of the reference PSO
(reference: optimization/particle_swarm_optimization.py:4-182,
optimization/particle_swarm_optimization_wrapper.py:10-573):

- the swarm state is one plain ``PSOState`` dataclass checkpointed
  atomically to a single JSON file (replacing append-only per-particle CSVs
  + the ``watch_optimization.py`` process-relaunch loop),
- the algorithm is the reference's: round-robin one-evaluation-per-call,
  velocity = momentum + propre + social (best of ``num_neighbours`` nearest
  particles), boundary reflection, and the epsilon-greedy explore/exploit
  rule that re-evaluates a particle's personal best and running-averages its
  noisy score — designed for stochastic objectives (a whole training run),
- a batch-synchronous mode (``ask_all``/``tell_all`` over all N particles)
  for an evaluator that scores the N candidate positions together.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_PSO_PARAMS = {
    # reference: optimization/particle_swarm_optimization_wrapper.py:42-50
    "num_particles": 5,
    "num_neighbours": 4,
    "alpha_momentum": 0.65,
    "alpha_propre": 0.25,
    "alpha_social": 0.25,
    "prob_explore": 0.75,
}


@dataclasses.dataclass
class PSOState:
    """Full swarm state in normalized [0, 1]^M space."""

    pos: np.ndarray  # (N, M)
    vel: np.ndarray  # (N, M)
    best_pos: np.ndarray  # (N, M)
    best_score: np.ndarray  # (N,)
    best_count: np.ndarray  # (N,) int
    n: int  # current particle (round-robin cursor)
    t: int  # completed evaluations
    exploring: bool  # whether the pending evaluation explores pos[n]
    elapsed: float  # accumulated wall time from previous runs
    rng_state: Optional[dict] = None  # serialized np.random.Generator state

    def to_json(self) -> dict:
        d = {
            "pos": self.pos.tolist(),
            "vel": self.vel.tolist(),
            "best_pos": self.best_pos.tolist(),
            "best_score": self.best_score.tolist(),
            "best_count": self.best_count.tolist(),
            "n": self.n,
            "t": self.t,
            "exploring": self.exploring,
            "elapsed": self.elapsed,
            "rng_state": self.rng_state,
        }
        return d

    @staticmethod
    def from_json(d: dict) -> "PSOState":
        return PSOState(
            pos=np.asarray(d["pos"], np.float64),
            vel=np.asarray(d["vel"], np.float64),
            best_pos=np.asarray(d["best_pos"], np.float64),
            best_score=np.asarray(d["best_score"], np.float64),
            best_count=np.asarray(d["best_count"], np.int64),
            n=int(d["n"]),
            t=int(d["t"]),
            exploring=bool(d["exploring"]),
            elapsed=float(d["elapsed"]),
            rng_state=d.get("rng_state"),
        )


class ParticleSwarmOptimization:
    """Round-robin PSO with epsilon-greedy explore/exploit
    (reference: optimization/particle_swarm_optimization.py:47-160)."""

    def __init__(
        self,
        num_dimensions: int,
        params: Optional[dict] = None,
        rng: Optional[np.random.Generator] = None,
        state: Optional[PSOState] = None,
    ):
        p = dict(DEFAULT_PSO_PARAMS)
        if params:
            p.update(params)
        self.params = p
        self.M = num_dimensions
        self.N = p["num_particles"]
        self.rng = rng if rng is not None else np.random.default_rng()

        if state is not None:
            self.state = state
            if state.rng_state is not None:
                self.rng.bit_generator.state = state.rng_state
        else:
            # random init (reference: pso.py:108-133): pos ~ U[0,1],
            # vel ~ 0.5*sqrt(M)*U[-1,1]
            pos = self.rng.random((self.N, self.M))
            vel = (
                0.5
                * np.sqrt(self.M)
                * 2.0
                * (self.rng.random((self.N, self.M)) - 0.5)
            )
            self.state = PSOState(
                pos=pos,
                vel=vel,
                best_pos=np.zeros_like(pos),
                best_score=np.full(self.N, np.inf),
                best_count=np.zeros(self.N, np.int64),
                n=self.N - 1,  # first ask() advances to particle 0
                t=0,
                exploring=True,
                elapsed=0.0,
            )

    # ----------------------------------------------------------------- ask
    def ask(self) -> np.ndarray:
        """Advance to the next particle and return the position to evaluate
        (reference: pso.py:47-70).  Lower scores are better."""
        s = self.state
        s.n = (s.n + 1) % self.N
        self._update_particle(s.n)

        # epsilon-greedy: explore the new position, or re-evaluate the
        # personal best to average its noisy score (reference: pso.py:63-70)
        if s.best_count[s.n] == 0 or self.rng.random() < self.params["prob_explore"]:
            s.exploring = True
            return s.pos[s.n].copy()
        s.exploring = False
        return s.best_pos[s.n].copy()

    # ---------------------------------------------------------------- tell
    def tell(self, score: float):
        """Report the score of the position returned by the last ask()
        (reference: pso.py:72-91)."""
        s = self.state
        n = s.n
        if s.exploring:
            if score < s.best_score[n]:
                s.best_score[n] = score
                s.best_pos[n] = s.pos[n]
                s.best_count[n] = 1
        else:
            s.best_score[n] = (s.best_count[n] * s.best_score[n] + score) / (
                s.best_count[n] + 1
            )
            s.best_count[n] += 1
        s.t += 1
        s.rng_state = self.rng.bit_generator.state

    def _update_particle(self, n: int):
        """Velocity/position update with nearest-neighbour social term and
        boundary reflection (reference: pso.py:135-160)."""
        s = self.state
        p = self.params
        dists = np.sum((s.pos - s.pos[n]) ** 2, axis=-1)
        neighbours = np.argsort(dists)[: p["num_neighbours"] + 1]
        best_nb = neighbours[np.argmin(s.best_score[neighbours])]

        vel = (
            p["alpha_momentum"] * s.vel[n]
            + p["alpha_propre"] * self.rng.random() * (s.best_pos[n] - s.pos[n])
            + p["alpha_social"]
            * self.rng.random()
            * (s.best_pos[best_nb] - s.pos[n])
        )
        pos = s.pos[n] + vel
        vel = np.where((pos < 0) | (pos > 1), -vel, vel)
        s.pos[n] = np.clip(pos, 0.0, 1.0)
        s.vel[n] = vel

    # --------------------------------------------------- per-particle API
    def ask_particle(self, n: int) -> Tuple[np.ndarray, bool]:
        """Velocity/position update + epsilon-greedy choice for particle
        ``n`` explicitly (no round-robin cursor) — the unit of work a
        multi-worker pool leases out (see :class:`MultiWorkerPSO`).

        Returns:
            (position to evaluate, exploring flag).
        """
        s = self.state
        self._update_particle(n)
        if s.best_count[n] == 0 or self.rng.random() < self.params["prob_explore"]:
            return s.pos[n].copy(), True
        return s.best_pos[n].copy(), False

    def tell_particle(self, n: int, exploring: bool, score: float):
        """Report the score of particle ``n``'s pending evaluation (the
        per-particle counterpart of :meth:`tell`; same update rules,
        reference: pso.py:72-91)."""
        s = self.state
        if exploring:
            if score < s.best_score[n]:
                s.best_score[n] = score
                s.best_pos[n] = s.pos[n]
                s.best_count[n] = 1
        else:
            s.best_score[n] = (s.best_count[n] * s.best_score[n] + score) / (
                s.best_count[n] + 1
            )
            s.best_count[n] += 1
        s.t += 1
        s.rng_state = self.rng.bit_generator.state

    # ------------------------------------------------- batch-synchronous API
    def ask_all(self) -> np.ndarray:
        """Batch-synchronous variant: update every particle and return all N
        candidate positions for one evaluation of the whole swarm.  Always
        explores."""
        s = self.state
        for n in range(self.N):
            self._update_particle(n)
        s.exploring = True
        return s.pos.copy()

    def tell_all(self, scores: np.ndarray):
        """Report scores for all N particles from ask_all()."""
        s = self.state
        scores = np.asarray(scores, np.float64)
        improved = scores < s.best_score
        s.best_score = np.where(improved, scores, s.best_score)
        s.best_pos = np.where(improved[:, None], s.pos, s.best_pos)
        s.best_count = np.where(improved, 1, s.best_count)
        s.t += self.N
        s.rng_state = self.rng.bit_generator.state

    # -------------------------------------------------------------- results
    @property
    def best(self) -> Tuple[np.ndarray, float]:
        i = int(np.argmin(self.state.best_score))
        return self.state.best_pos[i].copy(), float(self.state.best_score[i])


class HParamSpace:
    """Mapping between named hyper-parameters and normalized [0,1]^M space
    (reference: optimization/particle_swarm_optimization_wrapper.py:290-318,
    472-529).

    The search space is a {group: {param: [min, max]}} dict — the same JSON
    schema as the reference's ``optimization/hparams_lims.json``.
    """

    def __init__(self, lims: Dict[str, Dict[str, List[float]]]):
        self.groups: Dict[str, str] = {}
        self.order: List[str] = []
        lo, hi = [], []
        for group, params in lims.items():
            for name, (mn, mx) in params.items():
                if name in self.groups:
                    raise ValueError(f"duplicate hparam {name}")
                self.groups[name] = group
                self.order.append(name)
                lo.append(float(mn))
                hi.append(float(mx))
        self.lims = np.stack([lo, hi], axis=1)  # (M, 2)

    @staticmethod
    def from_json(path: str) -> "HParamSpace":
        with open(path) as f:
            return HParamSpace(json.load(f))

    @property
    def num_dimensions(self) -> int:
        return len(self.order)

    def denormalize(self, pos: np.ndarray) -> np.ndarray:
        return pos * (self.lims[:, 1] - self.lims[:, 0]) + self.lims[:, 0]

    def normalize(self, hparams: np.ndarray) -> np.ndarray:
        return (hparams - self.lims[:, 0]) / (self.lims[:, 1] - self.lims[:, 0])

    def to_name_dict(self, pos: np.ndarray) -> Dict[str, float]:
        h = self.denormalize(pos)
        return {name: float(h[i]) for i, name in enumerate(self.order)}

    def to_group_dict(self, pos: np.ndarray) -> Dict[str, Dict[str, float]]:
        nd = self.to_name_dict(pos)
        out: Dict[str, Dict[str, float]] = {}
        for name, val in nd.items():
            out.setdefault(self.groups[name], {})[name] = val
        return out

    def from_name_dict(self, nd: Dict[str, float]) -> np.ndarray:
        return self.normalize(
            np.array([nd[name] for name in self.order], np.float64)
        )


class PSOWrapper:
    """PSO over a named hyper-parameter space with crash-resumable state
    (reference: optimization/particle_swarm_optimization_wrapper.py:10-166).

    State lives in ``<save_dir>/pso_state.json`` (written atomically after
    every tell) plus an append-only ``pso_history.csv`` for analysis.  On
    construction, an existing state file is loaded and optimization resumes
    mid-swarm — the mechanism that made the reference's process-relaunch
    watchdog safe (watch_optimization.py:13-27), minus the watchdog.
    """

    def __init__(
        self,
        hparams_lims: "str | Dict",
        save_dir: str,
        T: float,
        termination_by_time: bool = True,
        rng: Optional[np.random.Generator] = None,
        pso_params: Optional[dict] = None,
    ):
        self.space = (
            HParamSpace.from_json(hparams_lims)
            if isinstance(hparams_lims, str)
            else HParamSpace(hparams_lims)
        )
        self.save_dir = save_dir
        self.T = T
        self.termination_by_time = termination_by_time
        self.time_start = time.time()
        os.makedirs(save_dir, exist_ok=True)
        self.state_path = os.path.join(save_dir, "pso_state.json")
        self.history_path = os.path.join(save_dir, "pso_history.csv")

        state = None
        self._elapsed_offset = 0.0
        if os.path.exists(self.state_path):
            with open(self.state_path) as f:
                payload = json.load(f)
            self._check_params(payload.get("pso_params", {}), pso_params)
            state = PSOState.from_json(payload["state"])
            self._elapsed_offset = state.elapsed

        self.pso = ParticleSwarmOptimization(
            num_dimensions=self.space.num_dimensions,
            params=pso_params,
            rng=rng,
            state=state,
        )
        if state is None:
            self._save()
        if not os.path.exists(self.history_path):
            with open(self.history_path, "w") as f:
                f.write(
                    ",".join(
                        ["iteration", "particle", "exploring", "score", "time"]
                        + self.space.order
                    )
                    + "\n"
                )

    def _check_params(self, loaded: dict, given: Optional[dict]):
        want = dict(DEFAULT_PSO_PARAMS)
        if given:
            want.update(given)
        for k, v in want.items():
            if k in loaded and loaded[k] != v:
                raise ValueError(
                    f"PSO param mismatch on resume: {k} loaded={loaded[k]} "
                    f"given={v}"
                )

    # ------------------------------------------------------------------ API
    def get_next_hparams(self, group_dict_layout: bool = False):
        """Next candidate as {param: val} (or grouped)
        (reference: wrapper.py:77-103)."""
        pos = self.pso.ask()
        self._pending_pos = pos
        if group_dict_layout:
            return self.space.to_group_dict(pos)
        return self.space.to_name_dict(pos)

    def update(self, score: float) -> bool:
        """Report score; persist state; return whether to terminate
        (reference: wrapper.py:105-121,380-394)."""
        self.pso.tell(score)
        self.pso.state.elapsed = (
            time.time() - self.time_start
        ) + self._loaded_elapsed()
        self._save()
        self._append_history(score)
        return self.terminated()

    def _loaded_elapsed(self) -> float:
        # wall time accumulated by previous (crashed/relaunched) runs
        return self._elapsed_offset

    def terminated(self) -> bool:
        s = self.pso.state
        at_round_end = s.n == self.pso.N - 1
        if self.termination_by_time:
            return s.elapsed >= self.T and at_round_end
        return s.t >= self.T and at_round_end

    @property
    def best_hparams(self) -> Dict[str, float]:
        pos, _ = self.pso.best
        return self.space.to_name_dict(pos)

    @property
    def best_score(self) -> float:
        return self.pso.best[1]

    # ------------------------------------------------------------ persistence
    def _save(self):
        payload = {
            "pso_params": self.pso.params,
            "hparams_order": self.space.order,
            "state": self.pso.state.to_json(),
        }
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.state_path)  # atomic on POSIX

    def _append_history(self, score: float):
        s = self.pso.state
        vals = self.space.to_name_dict(
            getattr(self, "_pending_pos", s.pos[s.n])
        )
        row = [
            str(s.t),
            str(s.n),
            str(int(s.exploring)),
            f"{score:.8g}",
            f"{s.elapsed:.3f}",
        ] + [f"{vals[k]:.8g}" for k in self.space.order]
        with open(self.history_path, "a") as f:
            f.write(",".join(row) + "\n")


@dataclasses.dataclass
class Lease:
    """A worker's claim on one particle's pending evaluation."""

    particle: int
    worker: str
    deadline: float  # unix time after which the lease may be re-claimed
    pos: List[float]  # the position under evaluation (normalized)
    exploring: bool

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "Lease":
        return Lease(
            particle=int(d["particle"]),
            worker=str(d["worker"]),
            deadline=float(d["deadline"]),
            pos=[float(x) for x in d["pos"]],
            exploring=bool(d["exploring"]),
        )


class MultiWorkerPSO:
    """Concurrent multi-worker PSO over the same atomic-JSON swarm state.

    The reference evaluates particles strictly serially in one process
    (reference: optimization/particle_swarm_optimization_wrapper.py:119-378
    — its file-per-particle CSVs *could* shard across processes but nothing
    coordinates them).  Here each worker is one training process (one
    card each, or workers taking turns on one card), all sharing this
    state.

    Protocol (every step runs under an exclusive ``flock`` on
    ``pso_state.lock`` and re-reads the state file, so workers never act on
    a stale snapshot):

    - :meth:`claim`: expire stale leases, pick the least-recently-evaluated
      unleased particle, apply the velocity/position update + the
      epsilon-greedy explore/exploit choice (`ask_particle`), and record a
      lease with a TTL.
    - :meth:`complete`: if the lease is still owned, apply the score
      (`tell_particle`), drop the lease, persist, append history.  A stale
      worker completing a lease that expired and was re-claimed is ignored
      (logged in history with particle ``-1``) — evaluations are idempotent
      to re-run, so at-least-once semantics are safe.
    - :meth:`renew`: extend a long evaluation's lease mid-run.

    A killed worker simply stops renewing: its lease expires and another
    worker re-claims the particle — the multi-process analogue of the
    reference's ``watch_optimization.py`` relaunch loop.  The lock file is
    per-directory, so multi-host workers need the save dir on a shared
    filesystem whose ``flock`` is coherent (or one worker group per host
    with distinct save dirs merged offline).
    """

    def __init__(
        self,
        hparams_lims: "str | Dict",
        save_dir: str,
        worker: str,
        T: float = 36000.0,
        termination_by_time: bool = True,
        lease_ttl: float = 3600.0,
        pso_params: Optional[dict] = None,
        seed: int = 21,
    ):
        self.space = (
            HParamSpace.from_json(hparams_lims)
            if isinstance(hparams_lims, str)
            else HParamSpace(hparams_lims)
        )
        self.save_dir = save_dir
        self.worker = str(worker)
        self.T = T
        self.termination_by_time = termination_by_time
        self.lease_ttl = float(lease_ttl)
        self.pso_params = pso_params
        self.seed = seed
        self.time_start = time.time()
        os.makedirs(save_dir, exist_ok=True)
        self.state_path = os.path.join(save_dir, "pso_state.json")
        self.lock_path = os.path.join(save_dir, "pso_state.lock")
        self.history_path = os.path.join(save_dir, "pso_history.csv")
        # create-or-validate the shared state once at startup
        with self._locked() as payload:
            self._write(payload)

    # ------------------------------------------------------------- locking
    @contextlib.contextmanager
    def _locked(self):
        """Exclusive cross-process critical section; yields the CURRENT
        state payload (creating it on first use)."""
        import fcntl

        fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield self._load()
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _load(self) -> dict:
        if os.path.exists(self.state_path):
            with open(self.state_path) as f:
                payload = json.load(f)
        else:
            pso = ParticleSwarmOptimization(
                num_dimensions=self.space.num_dimensions,
                params=self.pso_params,
                rng=np.random.default_rng(self.seed),
            )
            pso.state.rng_state = pso.rng.bit_generator.state
            payload = {
                "pso_params": pso.params,
                "hparams_order": self.space.order,
                "state": pso.state.to_json(),
                "leases": [],
                "last_claimed": [0.0] * pso.N,
            }
        payload.setdefault("leases", [])
        n = len(payload["state"]["pos"])
        payload.setdefault("last_claimed", [0.0] * n)
        if not os.path.exists(self.history_path):
            with open(self.history_path, "w") as f:
                f.write(
                    ",".join(
                        ["iteration", "particle", "exploring", "score",
                         "time", "worker"]
                        + self.space.order
                    )
                    + "\n"
                )
        return payload

    def _write(self, payload: dict):
        tmp = f"{self.state_path}.{self.worker}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.state_path)

    def _pso_from(self, payload: dict) -> ParticleSwarmOptimization:
        state = PSOState.from_json(payload["state"])
        rng = np.random.default_rng(self.seed)
        return ParticleSwarmOptimization(
            num_dimensions=self.space.num_dimensions,
            params=payload["pso_params"],
            rng=rng,
            state=state,
        )

    # ----------------------------------------------------------------- API
    def claim(self) -> Optional[dict]:
        """Lease the next particle to evaluate.

        Returns ``{"particle", "pos", "exploring", "hparams"}`` or ``None``
        when every particle is currently leased (back off and retry) or the
        budget is exhausted.
        """
        now = time.time()
        with self._locked() as payload:
            if self._terminated(payload, now):
                return None
            leases = [Lease.from_json(d) for d in payload["leases"]]
            live = [l for l in leases if l.deadline > now]
            # expired leases keep their pending evaluation: the velocity/
            # position update already ran at the ORIGINAL claim, so a
            # re-claim must re-issue the stored position rather than run
            # ask_particle again (which would take a second momentum step
            # for a single evaluation — one velocity update per evaluation,
            # reference: optimization/particle_swarm_optimization.py:47-70)
            expired: Dict[int, Lease] = {}
            for l in leases:
                if l.deadline <= now:
                    expired[l.particle] = l
            taken = {l.particle for l in live}
            pso = self._pso_from(payload)
            last = payload["last_claimed"]
            candidates = [
                n for n in range(pso.N) if n not in taken
            ]
            if not candidates:
                return None
            n = min(candidates, key=lambda i: last[i])
            if n in expired:
                pos = np.asarray(expired[n].pos, np.float64)
                exploring = expired[n].exploring
            else:
                pos, exploring = pso.ask_particle(n)
            pso.state.rng_state = pso.rng.bit_generator.state
            # retain other particles' expired leases (their pending
            # evaluations survive until re-claimed); n's own, if any, is
            # superseded by the fresh lease below
            live.extend(l for p, l in expired.items() if p != n)
            live.append(
                Lease(
                    particle=n,
                    worker=self.worker,
                    deadline=now + self.lease_ttl,
                    pos=[float(x) for x in pos],
                    exploring=exploring,
                )
            )
            last[n] = now
            payload["state"] = pso.state.to_json()
            payload["leases"] = [l.to_json() for l in live]
            payload["last_claimed"] = last
            self._write(payload)
            return {
                "particle": n,
                "pos": pos,
                "exploring": exploring,
                "hparams": self.space.to_group_dict(pos),
            }

    def renew(self, particle: int):
        """Extend this worker's lease on ``particle`` by one TTL."""
        now = time.time()
        with self._locked() as payload:
            changed = False
            for d in payload["leases"]:
                if d["particle"] == particle and d["worker"] == self.worker:
                    d["deadline"] = now + self.lease_ttl
                    changed = True
            if changed:
                self._write(payload)

    def complete(self, particle: int, score: float) -> bool:
        """Report the leased evaluation's score.  Returns False (and leaves
        the swarm untouched) when the lease expired and was re-claimed by
        another worker in the meantime."""
        now = time.time()
        with self._locked() as payload:
            leases = [Lease.from_json(d) for d in payload["leases"]]
            mine = [
                l for l in leases
                if l.particle == particle and l.worker == self.worker
            ]
            others = [
                l for l in leases
                if not (l.particle == particle and l.worker == self.worker)
            ]
            if not mine:
                self._history_row(payload, -1, False, score, None)
                return False
            lease = mine[-1]
            pso = self._pso_from(payload)
            # the lease's pos is authoritative: a later claim may have moved
            # pos[particle] (only possible through a stale double-claim),
            # and the score belongs to the position that was evaluated
            if lease.exploring:
                pso.state.pos[particle] = np.asarray(lease.pos, np.float64)
            pso.tell_particle(particle, lease.exploring, float(score))
            payload["state"] = pso.state.to_json()
            payload["state"]["elapsed"] = self._elapsed(payload, now)
            payload["leases"] = [l.to_json() for l in others]
            self._write(payload)
            self._history_row(payload, particle, lease.exploring, score,
                              lease.pos)
            return True

    def _elapsed(self, payload: dict, now: float) -> float:
        # track wall time from the swarm's first claim ever
        t0 = payload.setdefault("time_origin", now)
        return float(now - t0)

    def _terminated(self, payload: dict, now: float) -> bool:
        if self.termination_by_time:
            return self._elapsed(payload, now) >= self.T
        return payload["state"]["t"] >= self.T

    def terminated(self) -> bool:
        with self._locked() as payload:
            return self._terminated(payload, time.time())

    def _history_row(self, payload: dict, particle: int, exploring: bool,
                     score: float, pos: Optional[List[float]]):
        if pos is not None:
            nd = self.space.to_name_dict(np.asarray(pos, np.float64))
        else:  # stale completion: no authoritative position
            nd = {name: float("nan") for name in self.space.order}
        row = [
            str(payload["state"]["t"]),
            str(particle),
            str(int(exploring)),
            f"{score:.8g}",
            f"{payload['state'].get('elapsed', 0.0):.3f}",
            self.worker,
        ] + [f"{nd[k]:.8g}" for k in self.space.order]
        with open(self.history_path, "a") as f:
            f.write(",".join(row) + "\n")

    # -------------------------------------------------------------- results
    @property
    def best_hparams(self) -> Dict[str, float]:
        with self._locked() as payload:
            st = PSOState.from_json(payload["state"])
        i = int(np.argmin(st.best_score))
        return self.space.to_name_dict(st.best_pos[i])

    @property
    def best_score(self) -> float:
        with self._locked() as payload:
            st = PSOState.from_json(payload["state"])
        return float(np.min(st.best_score))
