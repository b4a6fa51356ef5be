"""scx-pulse HTTP exporter for the port: the Prometheus pull endpoint.

The port's copy of ``sctools_tpu.obs.serve``. Opt-in
(``SCTOOLS_TPU_PULSE_HTTP=<port>`` with pulse enabled, or programmatic
:class:`PulseExporter`): a daemon thread serves ``GET /metrics`` on
localhost with the process's :func:`sctools_tpu_torch.obs.render_metrics`
output (counters, gauges, span aggregates) followed by the pulse gauges
(:func:`sctools_tpu_torch.obs.pulse.render_pulse_metrics`) — windowed
cells/sec, occupancy, bytes/sec each direction, bubble fraction, and the
limiting stage. Standard Prometheus text exposition, so a scrape config
(or ``curl``) reads a live worker with zero library coupling.

Two modes:

- **live** (no ``run_dir``): serve THIS process's own recent heartbeats
  — the mode env activation wires into every worker;
- **run-dir**: serve the merged view of every ``pulse.*.ring`` under a
  run directory — what ``python -m sctools_tpu_torch.obs pulse <run_dir>
  --serve`` uses, giving a whole fleet one scrape target without
  touching the workers. When the run dir holds a serve journal the
  scrape also carries the per-tenant slo gauges
  (:func:`sctools_tpu_torch.obs.slo.render_slo_metrics`) and the
  per-tenant audit conservation gauges
  (:func:`sctools_tpu_torch.obs.audit.render_audit_metrics`): rows emitted
  and claimed per tenant and the fleet's unexplained count. JAX's steer
  gauges are not served: its controller is not ported.

Binds 127.0.0.1 only: telemetry is not an open network service. For
scrape-less setups the atomic textfile export
(``pulse.<worker>.prom``, :func:`sctools_tpu_torch.obs.pulse.export_textfile`)
carries the same exposition.
"""

from __future__ import annotations

import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

ENV_HTTP = "SCTOOLS_TPU_PULSE_HTTP"

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class PulseExporter:
    """A localhost /metrics endpoint over the pulse plane."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        run_dir: Optional[str] = None,
        window_s: Optional[float] = None,
    ):
        self._host = host
        self._port = port
        self._run_dir = run_dir
        self._window_s = window_s
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def render(self) -> str:
        """The exposition text one scrape returns."""
        from . import pulse, render_metrics

        if self._run_dir is not None:
            view = pulse.fleet_pulse(self._run_dir, window_s=self._window_s)
            body = pulse.render_pulse_metrics(view)
            # per-tenant scx-slo gauges ride the same scrape when the
            # run dir holds a serve journal; an empty stitch adds
            # nothing, and a stitch failure must not kill the pulse
            # scrape (label collisions still raise: fail loudly, never
            # merge two tenants into one series)
            from . import slo

            if slo.find_journal_dirs(self._run_dir):
                body += slo.render_slo_metrics(
                    slo.stitch_run(self._run_dir, window_s=self._window_s)
                )
                # per-tenant audit conservation gauges: rows emitted/claimed
                # per tenant plus the fleet unexplained count — the "is
                # anyone missing cells" alert series
                from . import audit

                body += audit.render_audit_metrics(self._run_dir)
            return body
        # live mode: the process's own counters/spans plus its pulse
        # gauges — render_metrics() raises on name-mangling collisions,
        # and render_pulse_metrics applies the same discipline
        # to its worker labels; a collision fails the scrape loudly
        # instead of silently merging two series
        return render_metrics() + pulse.render_pulse_metrics(
            pulse.live_pulse_view()
        )

    @property
    def port(self) -> Optional[int]:
        server = self._server
        return server.server_address[1] if server is not None else None

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = exporter.render().encode("utf-8")
                except Exception as error:  # noqa: BLE001 - scrape must not kill the worker
                    self.send_error(500, str(error)[:120])
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:  # silence per-scrape noise
                return None

        self._server = ThreadingHTTPServer(
            (self._host, self._port), _Handler
        )
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._serve, name="pulse-exporter", daemon=True,
        )
        self._thread.start()
        return self._server.server_address[1]

    def _serve(self) -> None:
        # the exporter thread's body: every scrape renders on a handler
        # thread the server spawns from here
        self._server.serve_forever()

    def stop(self) -> None:
        server = self._server
        if server is None:
            return
        server.shutdown()
        server.server_close()
        self._server = None
        self._thread = None


_exporter: Optional[PulseExporter] = None


def start_from_env() -> Optional[PulseExporter]:
    """Start the live exporter when ``SCTOOLS_TPU_PULSE_HTTP`` names a
    port (idempotent). Invalid values warn and stay off; a bind failure
    (port taken) warns and stays off — telemetry must never kill the
    worker it observes."""
    global _exporter
    if _exporter is not None:
        return _exporter
    raw = os.environ.get(ENV_HTTP, "").strip()
    # unset/empty = off; "0" = bind any free port (the --serve 0
    # semantics — the bound port is announced on stderr)
    if not raw:
        return None
    try:
        port = int(raw)
        if not (0 <= port <= 65535):
            raise ValueError(port)
    except ValueError:
        sys.stderr.write(
            f"sctools-tpu pulse: ignoring invalid {ENV_HTTP}={raw!r} "
            "(want a port number)\n"
        )
        return None
    exporter = PulseExporter(port=port)
    try:
        bound = exporter.start()
    except OSError as error:
        sys.stderr.write(
            f"sctools-tpu pulse: cannot bind exporter on port {port}: "
            f"{error}\n"
        )
        return None
    _exporter = exporter
    sys.stderr.write(
        f"sctools-tpu pulse: serving /metrics on 127.0.0.1:{bound}\n"
    )
    import atexit

    atexit.register(exporter.stop)
    return exporter
