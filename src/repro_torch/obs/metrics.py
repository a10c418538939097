"""Bounded-memory metrics core: counters, gauges, sketch histograms.

The fleet's observability plane in one dependency-free module.  A
:class:`MetricsRegistry` owns named instruments; each instrument carries
optional label dimensions (``engine="r0"``), and histograms are
:class:`~repro_torch.obs.sketch.QuantileSketch` instances — so everything the
registry holds is O(instruments x buckets), never O(observations), and
two registries (two replicas, two cells of a gateway tree) merge into a
fleet view with :meth:`MetricsRegistry.merge`.

Exposition is Prometheus text format (:meth:`MetricsRegistry.expose`):
counters/gauges as-is, histograms as summary-typed quantile series —
scrapeable by any Prometheus, parseable by the dashboard CLI, and
dumpable as a CI artifact.

Instruments are get-or-create: calling ``registry.counter("x", ...)``
twice returns the same object (re-registering with a different help
string or label set is an error — silent aliasing is how metric drift
hides).  All updates are plain float arithmetic on the host; nothing
here touches torch, devices, or wall clocks, so instrumented code stays
bit-deterministic under the simulator's virtual clocks.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

from repro_torch.obs.sketch import QuantileSketch

LabelKey = Tuple[str, ...]

_RESERVED = {"quantile"}      # exposition-owned label names


def _validate_labels(label_names: Sequence[str]) -> Tuple[str, ...]:
    names = tuple(label_names)
    bad = _RESERVED.intersection(names)
    if bad:
        raise ValueError(f"reserved label name(s): {sorted(bad)}")
    return names


class _Instrument:
    """Shared get-or-create child machinery for labeled instruments."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.label_names = _validate_labels(label_names)
        self._children: Dict[LabelKey, "_Instrument"] = {}
        if not self.label_names:
            self._children[()] = self

    def labels(self, **labels: str):
        """The child instrument for one label combination (created on
        first use, cached after — hot paths hold the child, not the
        parent)."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(labels[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._make_child()
            self._children[key] = child
        return child

    def _make_child(self):
        raise NotImplementedError

    def _series(self) -> Iterable[Tuple[LabelKey, "_Instrument"]]:
        return sorted(self._children.items())

    def _label_str(self, key: LabelKey, extra: str = "") -> str:
        parts = [f'{n}="{v}"' for n, v in zip(self.label_names, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Instrument):
    """Monotonically increasing count (ticks, frames, dispatches)."""

    kind = "counter"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str] = ()) -> None:
        super().__init__(name, help, label_names)
        self.value = 0.0

    def _make_child(self) -> "Counter":
        return Counter(self.name, self.help)

    def inc(self, amount: float = 1.0) -> None:
        if self.label_names:
            raise ValueError(f"{self.name} is labeled — call .labels() first")
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        self.value += amount


class Gauge(_Instrument):
    """Point-in-time value; may also wrap a probe callable so the value
    is read fresh at exposition time (the jit-recompile probe)."""

    kind = "gauge"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str] = ()) -> None:
        super().__init__(name, help, label_names)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def _make_child(self) -> "Gauge":
        return Gauge(self.name, self.help)

    def set(self, value: float) -> None:
        if self.label_names:
            raise ValueError(f"{self.name} is labeled — call .labels() first")
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.set(self._value + amount)

    def dec(self, amount: float = 1.0) -> None:
        self.set(self._value - amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Probe mode: ``value`` calls ``fn()`` at read time — for
        quantities owned elsewhere (jit cache sizes, queue depths)."""
        if self.label_names:
            raise ValueError(f"{self.name} is labeled — call .labels() first")
        self._fn = fn

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value


class Histogram(_Instrument):
    """Sketch-backed distribution (latencies, batch sizes): O(buckets)
    memory, mergeable, quantile-queryable within ``rel_err``."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str] = (),
                 rel_err: float = 0.01) -> None:
        super().__init__(name, help, label_names)
        self.rel_err = rel_err
        self.sketch = QuantileSketch(rel_err)

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, self.help, rel_err=self.rel_err)

    def observe(self, value: float) -> None:
        if self.label_names:
            raise ValueError(f"{self.name} is labeled — call .labels() first")
        self.sketch.add(value)

    @property
    def count(self) -> int:
        return self.sketch.count

    @property
    def sum(self) -> float:
        return self.sketch.sum

    def quantile(self, q: float) -> float:
        return self.sketch.quantile(q)


class MetricsRegistry:
    """Named instrument registry with exposition and fleet merge."""

    EXPOSE_QUANTILES = (50.0, 95.0, 99.0)

    def __init__(self) -> None:
        self._metrics: Dict[str, _Instrument] = {}

    # ------------------------------------------------------------------
    # get-or-create constructors
    # ------------------------------------------------------------------
    def _get(self, cls, name: str, help: str,
             label_names: Sequence[str], **kw):
        cur = self._metrics.get(name)
        if cur is not None:
            if (type(cur) is not cls
                    or cur.label_names != _validate_labels(label_names)):
                raise ValueError(
                    f"metric {name!r} already registered as {cur.kind} "
                    f"with labels {cur.label_names}")
            return cur
        inst = cls(name, help, label_names, **kw)
        self._metrics[name] = inst
        return inst

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  rel_err: float = 0.01) -> Histogram:
        return self._get(Histogram, name, help, label_names,
                         rel_err=rel_err)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def get(self, name: str) -> Optional[_Instrument]:
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self):
        return iter(sorted(self._metrics.values(), key=lambda m: m.name))

    def __len__(self) -> int:
        return len(self._metrics)

    # ------------------------------------------------------------------
    # fleet aggregation
    # ------------------------------------------------------------------
    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry (a replica's, a cell's) into this one:
        counters add, histogram sketches merge, gauges take the incoming
        reading (a merged gauge is a point sample, not a sum).  Label
        children union; same-name metrics must agree on type/labels.
        Returns self for chaining."""
        for name, inst in sorted(other._metrics.items()):
            mine = self._get(type(inst), name, inst.help, inst.label_names,
                             **({"rel_err": inst.rel_err}
                                if isinstance(inst, Histogram) else {}))
            for key, child in inst._series():
                target = (mine if not mine.label_names
                          else mine.labels(**dict(zip(mine.label_names,
                                                      key))))
                if isinstance(child, Counter):
                    target.value += child.value
                elif isinstance(child, Histogram):
                    target.sketch.merge(child.sketch)
                else:
                    target._fn = child._fn
                    target._value = child._value
        return self

    # ------------------------------------------------------------------
    # exposition
    # ------------------------------------------------------------------
    def expose(self) -> str:
        """Prometheus text exposition.  Histograms expose as summaries:
        ``name{quantile="0.5"}``-style series plus ``_sum``/``_count``."""
        lines = []
        for m in self:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            kind = "summary" if m.kind == "histogram" else m.kind
            lines.append(f"# TYPE {m.name} {kind}")
            for key, child in m._series():
                if isinstance(child, Histogram):
                    for q in self.EXPOSE_QUANTILES:
                        lab = m._label_str(key, f'quantile="{q / 100:g}"')
                        lines.append(
                            f"{m.name}{lab} {child.quantile(q):g}")
                    lab = m._label_str(key)
                    lines.append(f"{m.name}_sum{lab} {child.sum:g}")
                    lines.append(f"{m.name}_count{lab} {child.count}")
                else:
                    lines.append(
                        f"{m.name}{m._label_str(key)} {child.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")
