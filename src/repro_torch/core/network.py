"""Edge-device network model (paper §III.B).

Devices are heterogeneous: memory M_j(τ), max compute W_j, available compute
C_j(τ) <= W_j (background load), link bandwidths R_{j,k}(τ).  Sampled from
log-normal distributions per §V.B(b): M in [2,8] GB, C in [5,50] GFLOPS,
links in [1,10] Gbps, full connectivity.  Background tasks are injected as a
multiplicative availability process (mean-reverting), matching the paper's
"inject background tasks to emulate fluctuating compute load".

NumPy copy of the JAX package's ``core/network.py``: ``sample`` draws the
same numbers from the same seed, so Algorithm 1 places identically in both
packages.  ``from_mesh`` builds the homogeneous network of a device mesh,
with the reference's hop-scaled bandwidths and this port's card as its
defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

GB = 1024 ** 3
GFLOPS = 1e9
GBPS = 1e9 / 8  # bytes/sec per Gbps

# NVIDIA H100 80GB HBM3 (SXM5, 700 W power limit) data-sheet figures, the
# defaults of ``DeviceNetwork.from_mesh``: device memory, dense bf16
# tensor-core FLOP/s, and NVLink 4 bytes/s one way between two cards
H100_HBM_BYTES = 80 * GB
H100_PEAK_FLOPS_BF16 = 989e12
H100_NVLINK_BW = 450e9


@dataclasses.dataclass
class DeviceNetwork:
    """State of |V| devices and the |V|x|V| link matrix at interval tau."""

    mem_capacity: np.ndarray      # (V,) bytes, M_j(tau)
    compute_max: np.ndarray       # (V,) FLOP/s, W_j
    compute_avail: np.ndarray     # (V,) FLOP/s, C_j(tau)
    bandwidth: np.ndarray         # (V,V) bytes/s, R_{j,k}(tau)
    controller: int = 0           # node issuing inference requests
    rng: Optional[np.random.Generator] = None
    # background-load process parameters (§V.B "inject background tasks"):
    # tasks arrive per-device with prob `bg_arrival` per interval, consume a
    # U[0.3,0.7] fraction of W_j, and depart with prob 1/bg_duration —
    # persistent load shifts, plus small white-noise jitter.
    bg_volatility: float = 0.05
    bg_floor: float = 0.1
    bg_arrival: float = 0.01
    bg_duration: float = 150.0
    _bg_tasks: Optional[list] = None  # per-device list of load fractions
    _pinned_load: Optional["np.ndarray"] = None  # injected stragglers
    # Elastic churn state.  `active` is the liveness mask: a failed device
    # stays in the arrays (indices — and therefore permutation geometry —
    # never shift) but exposes zero availability and may not receive
    # blocks.  `_mem_avail` backs the *instantaneous* memory availability
    # M_j(τ) the controller observes, distinct from the hardware
    # `mem_capacity` (which observation must never overwrite — the
    # Controller.observe() conflation bug); until the first observation it
    # tracks capacity, so capacity edits keep constraining placement.
    active: Optional[np.ndarray] = None       # (V,) bool, liveness mask
    _mem_avail: Optional[np.ndarray] = None   # (V,) bytes, observed M_j(tau)

    def __post_init__(self):
        if self.active is None:
            self.active = np.ones(self.n_devices, dtype=bool)

    @property
    def mem_avail(self) -> np.ndarray:
        """(V,) observed memory availability; capacity until observed."""
        return self.mem_capacity if self._mem_avail is None \
            else self._mem_avail

    @mem_avail.setter
    def mem_avail(self, value):
        self._mem_avail = None if value is None \
            else np.asarray(value, float).copy()

    @property
    def n_devices(self) -> int:
        return len(self.mem_capacity)

    # ------------------------------------------------------------ liveness
    @property
    def n_active(self) -> int:
        return int(np.count_nonzero(self.active))

    @property
    def active_ids(self) -> np.ndarray:
        """Indices of live devices — the only legal placement targets."""
        return np.flatnonzero(self.active)

    def is_active(self, j: int) -> bool:
        return bool(self.active[j])

    def mem_usable(self) -> np.ndarray:
        """(V,) usable memory: observed availability, zero when inactive."""
        return np.where(self.active, self.mem_avail, 0.0)

    def fail(self, j: int):
        """Device j dies: zero availability, excluded from placement.
        Indices are preserved so existing placements/permutations remain
        addressable — the controller must evacuate, not reindex."""
        self.active[j] = False
        self.compute_avail[j] = 0.0
        if self._mem_avail is not None:
            self._mem_avail[j] = 0.0  # mem_usable() masks either way
        if self._pinned_load is not None:
            self._pinned_load[j] = 0.0

    def rejoin(self, j: int):
        """A previously failed device comes back, fresh (full capacity,
        no resident state).  The engine-facing join: physical slot
        geometry is fixed at construction, so an engine expansion is a
        slot re-activating — ``join`` (new index) is for the planning
        layers, whose placements are not tied to a cache shape."""
        self.active[j] = True
        if self._mem_avail is not None:
            self._mem_avail[j] = self.mem_capacity[j]
        self.compute_avail[j] = self.compute_max[j]
        if self._pinned_load is not None:
            self._pinned_load[j] = 0.0

    def slow(self, j: int, factor: float):
        """Device j becomes `factor`x slower (persistent pinned load)."""
        if factor < 1.0:
            raise ValueError(f"slowdown factor must be >= 1, got {factor}")
        if not self.active[j]:
            return
        self.inject_straggler(j, factor)

    def join(self, mem: float, compute: float,
             bw_row: "np.ndarray") -> int:
        """A new device joins with `mem` bytes, `compute` FLOP/s, and
        symmetric link bandwidths `bw_row` (len V) to the existing
        devices.  Returns the new device's index."""
        bw_row = np.asarray(bw_row, float)
        if bw_row.shape != (self.n_devices,):
            raise ValueError(
                f"bw_row must have shape ({self.n_devices},), "
                f"got {bw_row.shape}")
        if mem <= 0 or compute <= 0 or np.any(bw_row <= 0):
            raise ValueError("joining device needs positive mem/compute/bw")
        v = self.n_devices
        self.mem_capacity = np.append(self.mem_capacity, float(mem))
        if self._mem_avail is not None:
            self._mem_avail = np.append(self._mem_avail, float(mem))
        self.compute_max = np.append(self.compute_max, float(compute))
        self.compute_avail = np.append(self.compute_avail, float(compute))
        self.active = np.append(self.active, True)
        bw = np.full((v + 1, v + 1), np.inf)
        bw[:v, :v] = self.bandwidth
        bw[v, :v] = bw_row
        bw[:v, v] = bw_row
        self.bandwidth = bw
        if self._bg_tasks is not None:
            self._bg_tasks.append([])
        if self._pinned_load is not None:
            self._pinned_load = np.append(self._pinned_load, 0.0)
        return v

    # ------------------------------------------------------------- sampling
    @classmethod
    def sample(cls, n_devices: int, seed: int = 0, *,
               mem_range=(2 * GB, 8 * GB),
               compute_range=(5 * GFLOPS, 50 * GFLOPS),
               bw_range=(1 * GBPS, 10 * GBPS),
               controller: int = 0) -> "DeviceNetwork":
        """Log-normal heterogeneity clipped to the paper's ranges (§V.B)."""
        rng = np.random.default_rng(seed)

        def lognormal_in(lo, hi, size):
            mu, sigma = 0.0, 0.5
            raw = rng.lognormal(mu, sigma, size)
            # map quantiles of the lognormal into [lo, hi]
            lo_q, hi_q = np.exp(mu - 2 * sigma), np.exp(mu + 2 * sigma)
            x = np.clip((raw - lo_q) / (hi_q - lo_q), 0.0, 1.0)
            return lo + x * (hi - lo)

        mem = lognormal_in(*mem_range, n_devices)
        wmax = lognormal_in(*compute_range, n_devices)
        bw = lognormal_in(*bw_range, (n_devices, n_devices))
        bw = (bw + bw.T) / 2.0
        np.fill_diagonal(bw, np.inf)  # same-device transfer is free
        return cls(mem_capacity=mem, compute_max=wmax,
                   compute_avail=wmax.copy(), bandwidth=bw,
                   controller=controller, rng=rng)

    @classmethod
    def from_mesh(cls, shape, *, hbm_bytes=H100_HBM_BYTES,
                  peak_flops=H100_PEAK_FLOPS_BF16, link_bw=H100_NVLINK_BW,
                  seed: int = 0) -> "DeviceNetwork":
        """Homogeneous devices, one per mesh slot: ``shape`` is a mesh
        shape or a ``DeviceMesh``; R_{j,k} is ``link_bw`` scaled by the
        inverse hop count on the torus of that shape (the reference's
        model).  The defaults are one NVIDIA H100 80GB HBM3 (700 W) a
        slot."""
        if hasattr(shape, "mesh"):
            shape = tuple(shape.mesh.shape)
        coords = np.array(np.unravel_index(np.arange(np.prod(shape)),
                                           shape)).T
        n = len(coords)
        hops = np.zeros((n, n))
        for d, size in enumerate(shape):
            diff = np.abs(coords[:, None, d] - coords[None, :, d])
            hops += np.minimum(diff, size - diff)  # torus wrap
        hops = np.maximum(hops, 1)
        bw = link_bw / hops
        np.fill_diagonal(bw, np.inf)
        return cls(mem_capacity=np.full(n, float(hbm_bytes)),
                   compute_max=np.full(n, float(peak_flops)),
                   compute_avail=np.full(n, float(peak_flops)),
                   bandwidth=bw, controller=0,
                   rng=np.random.default_rng(seed))

    # ----------------------------------------------------------- dynamics
    def step_background_load(self):
        """Persistent background-task arrivals/departures + jitter."""
        assert self.rng is not None
        if self._bg_tasks is None:
            self._bg_tasks = [[] for _ in range(self.n_devices)]
        for j in self.active_ids:
            # departures
            self._bg_tasks[j] = [f for f in self._bg_tasks[j]
                                 if self.rng.random() > 1.0 / self.bg_duration]
            # arrivals
            if self.rng.random() < self.bg_arrival:
                self._bg_tasks[j].append(float(self.rng.uniform(0.3, 0.7)))
            load = sum(self._bg_tasks[j])
            pinned = 0.0 if self._pinned_load is None else self._pinned_load[j]
            jitter = self.rng.normal(0.0, self.bg_volatility)
            # injected stragglers may sink below the organic-load floor
            floor = self.bg_floor * (0.1 if pinned > 0 else 1.0)
            frac = np.clip(1.0 - load - pinned + jitter, floor, 1.0)
            self.compute_avail[j] = self.compute_max[j] * frac

    def inject_straggler(self, device: int, slowdown: float):
        """Fault-tolerance hook: device becomes `slowdown`x slower,
        persistently (survives step_background_load as pinned load)."""
        if not self.active[device]:
            return
        if self._pinned_load is None:
            self._pinned_load = np.zeros(self.n_devices)
        self._pinned_load[device] = 1.0 - 1.0 / slowdown
        self.compute_avail[device] = self.compute_max[device] / slowdown

    def restore(self, device: int):
        if not self.active[device]:
            return
        if self._pinned_load is not None:
            self._pinned_load[device] = 0.0
        self.compute_avail[device] = self.compute_max[device]

    def copy(self) -> "DeviceNetwork":
        return DeviceNetwork(self.mem_capacity.copy(), self.compute_max.copy(),
                             self.compute_avail.copy(), self.bandwidth.copy(),
                             self.controller, self.rng,
                             self.bg_volatility, self.bg_floor,
                             self.bg_arrival, self.bg_duration,
                             None if self._bg_tasks is None else
                             [list(t) for t in self._bg_tasks],
                             None if self._pinned_load is None else
                             self._pinned_load.copy(),
                             self.active.copy(),
                             None if self._mem_avail is None else
                             self._mem_avail.copy())
