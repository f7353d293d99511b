"""Structured JSON logging with trace context injection.

One stdlib-``logging`` formatter that renders each record as a single
JSON object and stamps it with whatever observability fields are bound
in the ambient context (:func:`repro_torch.obs.trace.use_context`) —
trace_id, span_id, tenant, bucket — so a grep for a trace id surfaces
the log lines *and* the spans of the same request.

``setup_logging("json")`` is what ``rpc/__main__.py --log-format json``
and ``scripts/serve_entrypoint_torch.sh`` call; ``"text"`` keeps the classic one-line
format for interactive use.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Optional

from repro_torch.obs.trace import current_context

# Fields every LogRecord carries that we either map explicitly or do
# not want echoed into the "extra" overflow.
_RESERVED = frozenset((
    "name", "msg", "args", "levelname", "levelno", "pathname", "filename",
    "module", "exc_info", "exc_text", "stack_info", "lineno", "funcName",
    "created", "msecs", "relativeCreated", "thread", "threadName",
    "processName", "process", "taskName", "message",
))

# Context keys promoted to top-level JSON fields (anything else bound
# via use_context lands under "ctx").
_CONTEXT_FIELDS = ("trace_id", "span_id", "tenant", "bucket")


class JsonFormatter(logging.Formatter):
    """Render records as one JSON object per line.

    Layout: ``ts`` (unix seconds), ``level``, ``logger``, ``msg``,
    then the promoted context fields when bound, ``exc`` for
    exceptions, and any ``extra=`` keys verbatim.  Values that json
    can't serialize fall back to ``repr`` — a log call must never
    throw out of the formatter.
    """

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        ctx = current_context()
        for key in _CONTEXT_FIELDS:
            if key in ctx:
                out[key] = ctx[key]
        rest = {k: v for k, v in ctx.items()
                if k not in _CONTEXT_FIELDS}
        if rest:
            out["ctx"] = rest
        for key, val in record.__dict__.items():
            if key not in _RESERVED and not key.startswith("_") \
                    and key not in out:
                out[key] = val
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        try:
            return json.dumps(out, default=repr)
        except (TypeError, ValueError):
            return json.dumps({"ts": out["ts"], "level": out["level"],
                               "logger": out["logger"],
                               "msg": str(out.get("msg"))})


class TextFormatter(logging.Formatter):
    """The classic human format, with trace id appended when bound."""

    def __init__(self) -> None:
        super().__init__(
            "%(asctime)s %(levelname)s %(name)s: %(message)s")
        self.converter = time.gmtime

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        trace_id = current_context().get("trace_id")
        if trace_id:
            line += f" trace={trace_id}"
        return line


def setup_logging(fmt: str = "text", level: int = logging.INFO,
                  stream: Optional[Any] = None,
                  logger: Optional[logging.Logger] = None
                  ) -> logging.Handler:
    """Install one stream handler with the chosen formatter on the
    root (or given) logger, replacing handlers installed by a previous
    call.  Returns the handler (tests capture its stream)."""
    if fmt not in ("text", "json"):
        raise ValueError(f"log format {fmt!r} not in ('text', 'json')")
    target = logger if logger is not None else logging.getLogger()
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonFormatter() if fmt == "json"
                         else TextFormatter())
    handler.set_name("repro-torch-obs")
    for h in list(target.handlers):
        if h.get_name() == "repro-torch-obs":
            target.removeHandler(h)
    target.addHandler(handler)
    target.setLevel(level)
    return handler
