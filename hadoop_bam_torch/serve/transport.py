"""Wire transports of the resident server: JSONL over a stream or TCP
(copy of hadoop_bam_tpu/serve/transport.py, single-replica).

One request per line::

    {"id": 1, "path": "a.bam", "regions": ["chr20:1-5000"],
     "tenant": "web", "priority": "interactive", "deadline_s": 0.5,
     "records": false}

(``region`` singular is accepted too.)  One response line per request,
keyed by ``id`` — responses stream back AS THEY COMPLETE, which with
priority classes is not submission order::

    {"id": 1, "tenant": "web", "latency_ms": 3.1,
     "results": [{"region": "chr20:1-5000", "count": 17,
                  "candidates": 94, "tile_hits": 1, "tile_misses": 0}]}

Failures answer on the same line protocol with the PR-1 taxonomy class
spelled out, so clients can implement retry policy without parsing
message strings — sheds (admission overflow, open tenant breakers, a
stopping loop) additionally carry the server's backoff hint::

    {"id": 2, "error": "...", "kind": "transient", "retry_after_s": 0.1}
    {"id": 3, "error": "...", "kind": "plan"}        # fix the request

``"cohort": true`` marks a cohort-slice request: ``path`` names a
cohort manifest JSON and each region slices the joined
``[variants, samples]`` tensor from device-resident dosage tiles
(cohort/serving.py); its results also carry ``n_samples`` /
``mean_af`` / ``quarantined``.

``{"op": "health"}`` answers out of band with the loop's breaker and
demotion-ladder state (``ServeLoop.health``) — the liveness/diagnosis
surface a degraded server keeps serving even while it sheds queries.

Fleet ops: the port has no serving fleet yet (ROADMAP Queue 1 item
11a), and answers them as the reference's single-replica server does:
``{"op": "heartbeat"}`` replies ``{"ok": true, "replica": null}``,
``{"op": "fleet"}`` replies ``{"fleet": null}``, and ``{"op": "chunk"}``
is a ``plan`` error.  A request's ``deadline_s`` is re-anchored by the
``enqueue_age_s`` it carries (``effective_deadline_s``, the reference's
``serve/fleet.py:89``, copied here).

The TCP flavor is a thread-per-connection ``socketserver`` veneer over
the same per-line handler; every connection funnels into the ONE
``ServeLoop`` dispatcher, so device work stays single-threaded no
matter how many sockets are open.  A dropped connection (real, or a
``serve.transport`` chaos fault) ends THAT stream only: in-flight
responses for it are abandoned at the socket, the dispatcher and every
other connection keep serving (pinned by tests).
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import threading
import time
from typing import Dict, List, Optional

from hadoop_bam_torch.obs.context import trace_context
from hadoop_bam_torch.resilience import chaos
from hadoop_bam_torch.utils.errors import (
    CircuitBreakerError, CorruptDataError, HBamError, PlanError,
    TransientIOError,
)
from hadoop_bam_torch.utils.metrics import METRICS

# sanity cap on the wire-carried enqueue age: a forwarded request must
# re-anchor to the originating budget, not to a corrupted timestamp
_MAX_ENQUEUE_AGE_S = 3600.0


def effective_deadline_s(deadline_s, enqueue_age_s) -> Optional[float]:
    """The budget a forwarded request has LEFT, re-anchored to the
    originating request's enqueue instant: the original ``deadline_s``
    minus the elapsed age carried on the wire.  None when the request is
    unbudgeted; clamps at 0.0 (an exhausted budget surfaces as an
    immediate deadline miss, never a fresh budget).  Copy of
    hadoop_bam_tpu/serve/fleet.py::effective_deadline_s."""
    if deadline_s is None:
        return None
    d = float(deadline_s)
    try:
        age = float(enqueue_age_s) if enqueue_age_s is not None else 0.0
    except (TypeError, ValueError):
        age = 0.0
    if not (0.0 <= age <= _MAX_ENQUEUE_AGE_S):
        age = 0.0
    return max(0.0, d - age)


def error_kind(exc: BaseException) -> str:
    """The taxonomy class a failed request reports on the wire."""
    if isinstance(exc, TransientIOError):
        return "transient"
    if isinstance(exc, (PlanError, FileNotFoundError)):
        # a bad path is configuration (file_identity's contract): never
        # retried, never quarantined
        return "plan"
    if isinstance(exc, CorruptDataError):
        return "corrupt"
    return "error"


def error_doc(req_id, exc: BaseException, kind: "str | None" = None,
              trace: "str | None" = None) -> Dict:
    """The wire shape of one failed request: taxonomy kind + the
    server's ``retry_after_s`` backoff hint when the shed carries one.
    ``trace`` echoes the request's trace_id so a client can hand the
    operator the exact id a flight dump / Chrome trace will show."""
    doc = {"id": req_id, "error": str(exc),
           "kind": kind if kind is not None else error_kind(exc)}
    if trace is not None:
        doc["trace"] = trace
    ra = getattr(exc, "retry_after_s", None)
    if ra is not None:
        doc["retry_after_s"] = round(float(ra), 4)
    return doc


def _result_doc(req_id, tenant: str, results, t_enqueue: float,
                trace: "str | None" = None) -> Dict:
    return {
        "id": req_id,
        "tenant": tenant,
        **({"trace": trace} if trace is not None else {}),
        "latency_ms": round((time.perf_counter() - t_enqueue) * 1e3, 3),
        "results": [
            {"region": r.region, "count": r.count,
             "candidates": r.n_candidates, "tile_hits": r.tile_hits,
             "tile_misses": r.tile_misses,
             # the cohort plane's aggregates ride the result verbatim
             **(r.extra if r.extra else {}),
             # region records carry to_line(); cohort slice records are
             # already wire-shaped dicts
             **({"records": [rec.to_line() if hasattr(rec, "to_line")
                             else rec for rec in r.records]}
                if r.records is not None else {})}
            for r in results],
    }


def _client_trace(v) -> "str | None":
    """A client-supplied trace id, adopted only when it is sane: a
    short token of [alnum_-] characters.  Anything else (wrong type,
    oversized, control characters) is ignored and a fresh id is minted
    — the id is stamped on every ring entry and incident dump, so an
    attacker-sized string must not ride it."""
    if isinstance(v, str) and 0 < len(v) <= 64 \
            and all(c.isalnum() or c in "-_" for c in v):
        return v
    return None


def _metrics_doc(loop, req: Dict) -> Dict:
    """The ``{"op": "metrics"}`` answer: the server's process-global
    metrics snapshot (mergeable ``to_dict`` form) plus SLO burn rates;
    ``"format": "prometheus"`` returns the text exposition with the
    ``hbam_slo_burn_rate`` gauge series appended instead."""
    from hadoop_bam_torch.obs.export import prometheus_text
    from hadoop_bam_torch.utils.metrics import base_metrics

    metrics = getattr(loop, "slo_metrics", None) or base_metrics()
    slo = getattr(loop, "slo", None)
    d = metrics.to_dict()
    if str(req.get("format", "")) == "prometheus":
        text = prometheus_text(d)
        if slo is not None:
            lines = slo.prometheus_lines(d)
            if lines:
                text += "\n".join(lines) + "\n"
        return {"prometheus": text}
    out: Dict = {"metrics": d}
    if slo is not None:
        out["slo"] = slo.burn_rates(d)
    return out


def handle_stream(loop, rfile, wfile) -> int:
    """Drive one JSONL request stream against ``loop`` until EOF;
    returns the number of requests handled.  Writes are serialized by a
    lock because responses complete out of order on the dispatcher
    thread while this thread keeps reading."""
    wlock = threading.Lock()
    # response-WRITTEN events, not bare futures: a future resolves
    # before its done-callback runs, and returning on future completion
    # would let a TCP handler close the socket under the in-flight
    # response write
    written: List[threading.Event] = []

    def write(doc: Dict) -> None:
        line = json.dumps(doc)
        with wlock:
            try:
                wfile.write(line + "\n")
                wfile.flush()
            except (OSError, ValueError):
                pass              # client went away mid-response

    n = 0
    try:
        for raw in rfile:
            # injectable disconnect (chaos point serve.transport): raises
            # ConnectionResetError exactly where a real peer reset
            # surfaces — the handler below ends THIS stream cleanly
            chaos.fire("serve.transport")
            line = raw.strip()
            if not line:
                continue
            n += 1
            req_id: object = n
            t_enqueue = time.perf_counter()
            trace_id: "str | None" = None
            try:
                doc = json.loads(line)
                if not isinstance(doc, dict):
                    raise PlanError("request must be a JSON object")
                req_id = doc.get("id", n)
                if doc.get("op") == "health":
                    # degraded-mode diagnosis surface: answered inline
                    # on the reader thread (never enters the dispatch
                    # heap, so it works even when every tenant sheds)
                    write({"id": req_id, "health": loop.health()})
                    continue
                if doc.get("op") == "metrics":
                    # live metrics surface (`hbam top`'s poll target):
                    # the server's process-global snapshot + SLO burn
                    # rates, also answered inline on the reader thread
                    write({"id": req_id, **_metrics_doc(loop, doc)})
                    continue
                # single-replica answers to the fleet ops (module
                # docstring): no fleet is ported yet
                if doc.get("op") == "heartbeat":
                    write({"id": req_id, "ok": True, "replica": None})
                    continue
                if doc.get("op") == "fleet":
                    write({"id": req_id, "fleet": None})
                    continue
                if doc.get("op") == "chunk":
                    raise PlanError("peer chunk op on a non-fleet server")
                regions = doc.get("regions")
                if regions is None:
                    regions = [doc["region"]] if "region" in doc else None
                if not regions or "path" not in doc:
                    raise PlanError(
                        'request needs "path" and "regions" (or "region")')
                # fleet hop: the deadline re-anchors to the ORIGINATING
                # request's enqueue instant — the original budget minus
                # the age it already spent upstream, never a fresh one
                deadline_s = effective_deadline_s(
                    doc.get("deadline_s"), doc.get("enqueue_age_s"))
                # ONE trace per request line, minted here at the wire —
                # loop.submit's contextvars snapshot carries it through
                # the dispatcher, the decode pool and the staging
                # packer, and the response line echoes it back; a
                # client- or peer-supplied "trace" is adopted (validated)
                # so a forwarded fleet request keeps its originating id
                with trace_context(
                        op="serve.request",
                        tenant=str(doc.get("tenant", "default")),
                        deadline_s=deadline_s,
                        trace_id=_client_trace(doc.get("trace"))) as tctx:
                    trace_id = tctx.trace_id
                    fut = loop.submit(
                        doc["path"], regions,
                        tenant=str(doc.get("tenant", "default")),
                        priority=str(doc.get("priority", "interactive")),
                        deadline_s=deadline_s,
                        want_records=bool(doc.get("records", False)),
                        cohort=bool(doc.get("cohort", False)))
            except (ValueError, KeyError, TypeError) as e:
                # malformed line / PlanError-class rejection: answer,
                # keep serving the stream (one bad client line must not
                # kill the connection)
                write(error_doc(req_id, e,
                                kind=None if isinstance(e, HBamError)
                                else "plan", trace=trace_id))
                continue
            except (TransientIOError, CircuitBreakerError, OSError) as e:
                # admission / tenant-breaker / quarantine-circuit shed:
                # a classified answer with the backoff hint, never a
                # hang and never a dropped connection (a bare
                # RuntimeError is a bug and must propagate, not serve)
                write(error_doc(req_id, e, trace=trace_id))
                continue

            ev = threading.Event()

            def _done(f: cf.Future, req_id=req_id,
                      tenant=str(doc.get("tenant", "default")),
                      t_enqueue=t_enqueue, ev=ev,
                      trace_id=trace_id) -> None:
                try:
                    exc = f.exception()
                    if exc is not None:
                        write(error_doc(req_id, exc, trace=trace_id))
                    else:
                        # the response write runs on the dispatcher
                        # thread inside the job's context — this span
                        # is the tail of the request's causal tree
                        with METRICS.span("serve.response_wall"):
                            write(_result_doc(req_id, tenant,
                                              f.result(), t_enqueue,
                                              trace=trace_id))
                finally:
                    ev.set()

            fut.add_done_callback(_done)
            written.append(ev)
            # prune responses already on the wire: a connection held
            # open for millions of requests must not grow this list
            # without bound (the SV802 discipline, applied to a local)
            if len(written) > 64:
                written[:] = [e for e in written if not e.is_set()]
    except OSError:
        # the connection died mid-read (peer reset / injected
        # disconnect): stop reading THIS stream; queued work still
        # completes below and the server keeps serving other streams
        METRICS.count("serve.transport_disconnects")
    for ev in written:
        ev.wait(timeout=60.0)
    return n


def serve_stdio(loop, rfile=None, wfile=None) -> int:
    """The ``hbam serve`` default transport: JSONL on stdin/stdout."""
    import sys
    return handle_stream(loop, rfile if rfile is not None else sys.stdin,
                         wfile if wfile is not None else sys.stdout)


def make_tcp_server(loop, host: str = "127.0.0.1", port: int = 0):
    """A ``ThreadingTCPServer`` speaking the JSONL protocol per
    connection; caller owns ``serve_forever()`` / ``shutdown()``.  The
    bound address is ``server.server_address`` (pass ``port=0`` for an
    ephemeral port — how the tests run it)."""
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def handle(self) -> None:
            rfile = (line.decode("utf-8", "replace")
                     for line in self.rfile)
            import io

            class _W(io.TextIOBase):
                def write(inner, s: str) -> int:  # noqa: N805
                    self.wfile.write(s.encode())
                    return len(s)

                def flush(inner) -> None:  # noqa: N805
                    pass

            handle_stream(loop, rfile, _W())

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return Server((host, int(port)), Handler)
