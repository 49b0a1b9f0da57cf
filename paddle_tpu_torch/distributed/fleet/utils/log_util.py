"""Structured logging — the port's copy of `log_json` from
`paddle_tpu/distributed/fleet/utils/log_util.py`.

`log_json(event, **fields)` logs one record on the `paddle_tpu_torch.fleet`
logger (a child of it with `logger_name`) whose `event` and `fields`
attributes carry the machine-readable payload. The logger gets one
stderr handler writing a JSON line per record, in the reference's
schema:

  {"ts": epoch_seconds, "level": "ERROR", "logger": name,
   "event": str|null, "msg": str, "fields": {...}}

The handler is installed on the first call, not at import.
"""
import json
import logging
import sys

logger = logging.getLogger('paddle_tpu_torch.fleet')

_LEVELS = {'debug': logging.DEBUG, 'info': logging.INFO,
           'warning': logging.WARNING, 'error': logging.ERROR,
           'critical': logging.CRITICAL}


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


class JsonLineFormatter(logging.Formatter):
    def format(self, record):
        doc = {'ts': record.created, 'level': record.levelname,
               'logger': record.name,
               'event': getattr(record, 'event', None),
               'msg': record.getMessage()}
        fields = getattr(record, 'fields', None)
        if fields:
            doc['fields'] = {k: _jsonable(v) for k, v in fields.items()}
        return json.dumps(doc)


def _configure():
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(JsonLineFormatter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False


def log_json(event, level='info', logger_name=None, msg=None, **fields):
    """Structured log entry: `event` is the machine key, `fields` the
    payload; msg defaults to the event name."""
    _configure()
    lg = logger.getChild(logger_name) if logger_name else logger
    lg.log(_LEVELS.get(str(level).lower(), logging.INFO),
           msg if msg is not None else event,
           extra={'event': event, 'fields': fields or None})
