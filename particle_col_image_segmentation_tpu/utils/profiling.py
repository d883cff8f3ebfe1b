"""Pipeline-stage tracing (SURVEY.md §5: build jax.profiler annotations +
MP/s counters; the reference has none).

Host spans: ``stage`` (a TraceAnnotation plus wall-time totals).  Device
spans: the device graphs open ``jax.named_scope(<stage>)`` around each
stage (``DEVICE_STAGES``); ``device_stage_times`` reduces a profiler trace
to device milliseconds per stage through XLA's HLO dumps."""

from __future__ import annotations

import contextlib
import glob
import os
import re
import time
from typing import Dict, Iterator, Optional, Tuple

from particle_col_image_segmentation_tpu.utils.logging import get_logger

_log = get_logger("profile")

# cumulative wall time per stage name for this process
STAGE_TOTALS: Dict[str, float] = {}


@contextlib.contextmanager
def stage(name: str, megapixels: Optional[float] = None) -> Iterator[None]:
    """Annotate a pipeline stage: a jax.profiler TraceAnnotation (visible in
    XLA traces) plus wall-time / MP/s accounting."""
    import jax

    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    dt = time.perf_counter() - t0
    STAGE_TOTALS[name] = STAGE_TOTALS.get(name, 0.0) + dt
    if megapixels is not None and dt > 0:
        _log.debug("%s: %.1f ms (%.1f MP/s)", name, dt * 1e3, megapixels / dt)
    else:
        _log.debug("%s: %.1f ms", name, dt * 1e3)


# Device-side stage names: the ``jax.named_scope`` each device graph opens
# around a pipeline stage (labels/analysis.py, models/batch.py,
# models/refine.py, models/nanosims.py).
DEVICE_STAGES = (
    "median", "ccl", "compact", "tables", "fill", "merge", "dedup", "edt",
    "maxima", "watershed", "roi",
)

_HLO_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_HLO_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def _scope_stage(op_name: str) -> Optional[str]:
    """The OUTERMOST stage scope on an op_name path (so an EDT inside the
    fill stage counts as fill), or None."""
    for part in op_name.split("/"):
        if part in DEVICE_STAGES:
            return part
    return None


def hlo_op_stages(hlo_dump_dir: str) -> Dict[Tuple[str, str], str]:
    """{(module, instruction): stage} from XLA's optimized-HLO text dumps
    (``XLA_FLAGS=--xla_dump_to=DIR --xla_dump_hlo_as_text``).  An
    instruction takes the stage of its own op_name metadata; a fusion
    without metadata takes the stage of the computation it calls.  Each
    name is also keyed in its kernel spelling (``.``/``-`` → ``_``): a
    kernel replayed from a CUDA graph reports ``hlo_op="command_buffer"``
    and only its kernel name identifies the instruction."""
    out: Dict[Tuple[str, str], str] = {}
    for path in glob.glob(os.path.join(hlo_dump_dir, "*after_optimizations.txt")):
        module, comp = None, None
        comp_stage: Dict[str, str] = {}
        pending = []  # (instruction, called computation) without metadata
        with open(path) as f:
            for line in f:
                if module is None and line.startswith("HloModule "):
                    module = line.split()[1].rstrip(",")
                    continue
                m = _HLO_COMP.match(line)
                if m is not None and "=" not in line.split("(")[0]:
                    comp = m.group(1)
                    continue
                m = _HLO_INSTR.match(line)
                if m is None or module is None:
                    continue
                name_m = _OP_NAME.search(line)
                st = _scope_stage(name_m.group(1)) if name_m else None
                if st is not None:
                    out[(module, m.group(1))] = st
                    out[(module, _kernel_name(m.group(1)))] = st
                    if comp is not None:
                        comp_stage.setdefault(comp, st)
                else:
                    calls = _CALLS.search(line)
                    if calls is not None:
                        pending.append((m.group(1), calls.group(1)))
        for instr, called in pending:
            if called in comp_stage:
                out[(module, instr)] = comp_stage[called]
                out[(module, _kernel_name(instr))] = comp_stage[called]
    return out


def _kernel_name(instr: str) -> str:
    return instr.replace(".", "_").replace("-", "_")


def device_stage_times(trace_dir: str, op_stages) -> Dict[str, float]:
    """Device milliseconds per stage from a ``jax.profiler`` trace.

    Sums the durations of every event on the device planes (those with a
    ``hlo_op`` stat) by ``op_stages[(hlo_module, hlo_op)]``; unmapped ops
    land in "other".  Also returns "total" (sum of all device op time) and
    "window" (first start to last end on the device timeline)."""
    from jax.profiler import ProfileData

    planes = [
        plane
        for path in glob.glob(
            os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")
        )
        for plane in ProfileData.from_file(path).planes
    ]
    # accelerator ops run on "/device:" planes; the CPU backend runs them
    # on host threads, so fall back to every plane when there is none
    device = [p for p in planes if p.name.startswith("/device:")]
    times: Dict[str, float] = {}
    first, last = None, None
    for plane in device or planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                module = stats.get("hlo_module")
                stage_name = op_stages.get(
                    (module, op),
                    op_stages.get((module, _kernel_name(ev.name)), "other"),
                )
                ms = ev.duration_ns / 1e6
                times[stage_name] = times.get(stage_name, 0.0) + ms
                times["total"] = times.get("total", 0.0) + ms
                t0, t1 = ev.start_ns, ev.start_ns + ev.duration_ns
                first = t0 if first is None else min(first, t0)
                last = t1 if last is None else max(last, t1)
    if first is not None:
        times["window"] = (last - first) / 1e6
    return times
