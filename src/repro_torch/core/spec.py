"""SessionSpec: the one session-describing object across loader/service/wire.

Every way of standing up a Redox data session — a co-located
:class:`~repro.core.loader.RedoxLoader`, a
:meth:`repro.service.DataService.open_session` call, or an
``open_session`` message on the out-of-process transport
(:mod:`repro.service.transport`) — used to spell the same ~10 knobs as its
own keyword list. :class:`SessionSpec` is the single frozen value object
they all accept: protocol policy and RNG seeds, cluster/batch geometry,
the execution engine, and the prefetch/plan-ahead depths. It is plain
data (JSON round-trippable by construction, because the wire protocol
ships it), so a spec built for a local loader is byte-for-byte the spec a
remote trainer sends to the service.

The legacy kwarg spellings (and the ``use_planner`` alias for
``engine``) remain as thin deprecation shims at each call site;
``tests/test_service.py`` asserts the shims and the spec form build
identical sessions.

:class:`StoreSpec` gives the *store* the same treatment (DESIGN.md §15):
one frozen value object for storage configuration — backend + backend
kwargs, codec, compression level, fidelity bands — persisted by
``ChunkStore.build`` as ``store.json`` in the store root so
``ChunkStore.open(root)`` needs no flags, and shipped over the wire so a
remote trainer resolves the served store's codec without guessing.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SessionSpec", "StoreSpec"]

_ENGINES = ("replay", "step", "per_access")


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """Frozen description of one training job's data session.

    ``seed`` drives the protocol RNG (refill tie-breaks); ``sampler_seed``
    the per-epoch access permutation (defaults to ``seed + 1``, the
    historical convention). ``queue_depth`` doubles as the session's
    plan-ahead depth: the async loader's prefetch queue in-process, the
    shared-memory ring's frame budget out-of-process.
    """

    policy: str = "max_fill"
    seed: int = 0
    sampler_seed: "int | None" = None
    num_nodes: int = 1
    batch_per_node: int = 8
    seq_len: int = 128
    pad_id: int = 0
    engine: str = "replay"
    prefetch: bool = True
    prefetch_window: int = 64
    remote_memory_limit_bytes: int = 1 << 62
    queue_depth: int = 2
    #: Decode only the first ``fidelity`` bands of a progressive store
    #: (None = full fidelity). Ignored by stores built with ``bands=1``.
    fidelity: "int | None" = None

    def __post_init__(self):
        if self.engine not in _ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; expected one of {_ENGINES}"
            )
        if self.num_nodes < 1 or self.batch_per_node < 1 or self.seq_len < 1:
            raise ValueError(
                "num_nodes, batch_per_node and seq_len must be positive, got "
                f"{self.num_nodes}/{self.batch_per_node}/{self.seq_len}"
            )
        if self.fidelity is not None and self.fidelity < 1:
            raise ValueError(f"fidelity must be >= 1, got {self.fidelity}")

    # --------------------------------------------------------------- derived
    @property
    def effective_sampler_seed(self) -> int:
        return self.seed + 1 if self.sampler_seed is None else self.sampler_seed

    @property
    def global_batch(self) -> int:
        return self.num_nodes * self.batch_per_node

    def replace(self, **changes) -> "SessionSpec":
        return dataclasses.replace(self, **changes)

    # ------------------------------------------------------------------ wire
    def to_json(self) -> dict:
        """A plain-JSON dict (the wire form; also what launchers log)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "SessionSpec":
        """Inverse of :meth:`to_json`. Unknown keys are rejected — a typo'd
        knob silently falling back to a default is exactly the bug class
        this object exists to kill."""
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(data) - known
        if extra:
            raise ValueError(f"unknown SessionSpec fields: {sorted(extra)}")
        return cls(**data)

    # ------------------------------------------------------------ kwarg shim
    @classmethod
    def from_kwargs(cls, **kwargs) -> "SessionSpec":
        """Build a spec from the legacy keyword spelling (deprecation shim).

        Accepts exactly the old ``DataService.open_session`` /
        ``RedoxLoader`` keyword set, including the ``use_planner`` boolean
        alias for ``engine`` (``True`` -> ``"replay"``, ``False`` ->
        ``"step"``). New call sites should construct a SessionSpec.
        """
        use_planner = kwargs.pop("use_planner", None)
        if use_planner is not None:
            if kwargs.get("engine") is not None:
                raise ValueError("pass either use_planner or engine, not both")
            kwargs["engine"] = "replay" if use_planner else "step"
        elif kwargs.get("engine") is None:
            kwargs.pop("engine", None)
        return cls.from_json(kwargs)


@dataclasses.dataclass(frozen=True)
class StoreSpec:
    """Frozen description of one chunk store's byte representation + backend.

    ``codec``/``level``/``bands`` are *layout* properties — they describe
    the bytes on disk, are fixed at build time, and round-trip through the
    ``store.json`` sidecar. ``backend``/``backend_kwargs`` are the store's
    *default* read path; an explicit ``backend=`` at ``ChunkStore.open``
    may override them (a runtime choice), but a conflicting layout is
    refused. ``bands > 1`` or ``codec != "none"`` selects the framed
    progressive layout; the default spec is byte-identical to the legacy
    raw concatenation.
    """

    backend: str = "vfs"
    backend_kwargs: dict = dataclasses.field(default_factory=dict)
    codec: str = "none"
    level: int = -1
    bands: int = 1

    def __post_init__(self):
        # Deferred import: repro.core.storage imports this module at load
        # time; by the time a StoreSpec is constructed both are initialised.
        from .storage.codec import CODECS

        if self.codec not in CODECS:
            raise ValueError(
                f"unknown codec {self.codec!r}; expected one of {sorted(CODECS)}"
            )
        if not isinstance(self.backend, str) or not self.backend:
            raise ValueError(f"backend must be a backend name, got {self.backend!r}")
        if not 1 <= self.bands <= 255:
            raise ValueError(f"bands must be in 1..255, got {self.bands}")

    # --------------------------------------------------------------- derived
    @property
    def framed(self) -> bool:
        """True when chunk files carry the frame container (codec/bands)."""
        return self.codec != "none" or self.bands > 1

    def layout_fields(self) -> dict:
        return {"codec": self.codec, "level": self.level, "bands": self.bands}

    def replace(self, **changes) -> "StoreSpec":
        return dataclasses.replace(self, **changes)

    # ------------------------------------------------------------------ wire
    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "StoreSpec":
        """Inverse of :meth:`to_json`; unknown keys are rejected."""
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(data) - known
        if extra:
            raise ValueError(f"unknown StoreSpec fields: {sorted(extra)}")
        data = dict(data)
        data["backend_kwargs"] = dict(data.get("backend_kwargs") or {})
        return cls(**data)

    # ------------------------------------------------------------ kwarg shim
    @classmethod
    def from_kwargs(cls, backend="vfs", **kwargs) -> "StoreSpec":
        """Build a spec from the legacy ``ChunkStore`` keyword spelling.

        ``backend`` may be a name or a live :class:`StorageBackend`
        instance (the historical call form) — an instance contributes its
        ``name`` and the store keeps using the instance itself. Remaining
        keywords are StoreSpec fields; anything else is a backend kwarg.
        """
        if not isinstance(backend, str):
            backend = getattr(backend, "name", "vfs")
        fields = {f.name for f in dataclasses.fields(cls)}
        spec_kw = {k: v for k, v in kwargs.items() if k in fields}
        extra = {k: v for k, v in kwargs.items() if k not in fields}
        if extra:
            spec_kw.setdefault("backend_kwargs", {}).update(extra)
        return cls(backend=backend, **spec_kw)
