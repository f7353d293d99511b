#!/usr/bin/env bash
# Container entrypoint for the PyTorch/CUDA LP RPC server: set the
# runtime environment, then exec `python -m repro_torch.serve_lp.rpc`.
# Serves on every visible CUDA card (refuses to start without one).
#
# Every export here is overridable from the outside environment
# (`VAR=... serve_entrypoint_torch.sh` wins); CLI flags pass through, e.g.
#
#   scripts/serve_entrypoint_torch.sh --port 8080 --target-p99-ms 50
set -euo pipefail

# tcmalloc on the serving hot path (flush-buffer churn); skip silently
# where it isn't baked in.
TCMALLOC=/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4
if [[ -z "${LD_PRELOAD:-}" && -f "$TCMALLOC" ]]; then
    export LD_PRELOAD="$TCMALLOC"
    # and keep it quiet about the large flush-buffer arenas
    export TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD="${TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD:-60000000000}"
fi

# Multi-host serving is not implemented in repro_torch: the module raises
# when SERVE_COORDINATOR is set, rather than serving one host quietly.

cd "$(dirname "$0")/.."
export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$(pwd)/src"

# Containers log to collectors, not humans: default to structured JSON
# lines (one object per line, trace_id/tenant bound from the request
# context).  A caller passing its own --log-format wins.
LOG_FORMAT_ARGS=(--log-format json)
for arg in "$@"; do
    [[ "$arg" == --log-format* ]] && LOG_FORMAT_ARGS=()
done

exec /usr/bin/env python3 -m repro_torch.serve_lp.rpc "${LOG_FORMAT_ARGS[@]}" "$@"
