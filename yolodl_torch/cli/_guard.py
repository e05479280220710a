"""CLI error boundary: user-facing errors print one clear line, not a wall.

Counterpart of ``yolodl_tpu/cli/_guard.py``, with its exit codes (0, 1 for a
user error, 130 on Ctrl-C, 141 on a closed stdout) and its one-line
``error: ...`` format.  The reference CLIs surface config problems as
anyhow error chains rather than panics (train/src/main.rs:23,
detect/src/main.rs:32); the equivalent here is catching the exception types
our config/dataset layers raise for user mistakes and printing
``error: ...``.  Unexpected exceptions still traceback, and
``YOLODL_DEBUG=1`` forces tracebacks for everything.

Three more kinds of error are the user's to act on in the port: a part
that is not ported yet (``NotImplementedError``, whose message names its
ROADMAP item), no card without ``--device cpu``, and a failed rank of a
MultiDevice run (``RankFailed``).  A rank that ``parallel/mesh.py``
``launch_ranks`` started hands its error line to the parent instead of
printing it, so that the run prints one ``error:`` line.

The reference's two JAX settings have no counterpart here: its persistent
XLA compile cache (eager PyTorch compiles nothing; the CUDA kernels are
built once per checkout by ``kernels/_build.py``) and ``YDL_DEBUG_NANS``
(``jax_debug_nans`` re-runs jitted code op by op; eager PyTorch already runs
op by op, and ``torch.autograd.set_detect_anomaly`` is the tool for a
backward).
"""

from __future__ import annotations

import os
import sys

from .._device import NoCudaDeviceError
from ..parallel.mesh import RankFailed, write_rank_error

# Exception types raised for user mistakes (bad paths, malformed JSON5/cfg,
# wrong version, schema violations), for parts not ported yet and for a
# missing card.  Everything else — including TypeError, which essentially
# always signals a programming bug — keeps its traceback.  The one-liner
# includes the raise site so a misclassified internal ValueError/KeyError is
# still reportable without rerunning.
_USER_ERRORS = (
    FileNotFoundError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
    ValueError,
    KeyError,
    NotImplementedError,
    NoCudaDeviceError,
    RankFailed,
)


def run(main) -> None:
    """``main()`` behind the error boundary, exiting with its code.  A rank
    of a multi-process run (RANK and WORLD_SIZE set, as ``launch_ranks``
    and torchrun set them) leaves through ``os._exit`` once its streams
    are flushed: the training data's daemon threads may still be inside
    native code, and the interpreter's teardown would end such a thread
    in a C++ frame that cannot unwind ("terminate called without an
    active exception", the process killed by SIGABRT)."""
    from ..parallel.mesh import rank_environment

    try:
        _run(main)
    except SystemExit as e:
        if rank_environment() is None:
            raise
        code = e.code
        if code is not None and not isinstance(code, int):
            print(code, file=sys.stderr)  # what the interpreter would print
            code = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code or 0)


def _run(main) -> None:
    try:
        rc = main()
        # some mains return their result object for tests; only ints are
        # exit codes
        sys.exit(rc if isinstance(rc, int) else 0)
    except KeyboardInterrupt:
        sys.exit(130)
    except BrokenPipeError:
        # stdout consumer (e.g. `| head`) went away: the Unix convention is
        # a silent exit, not a traceback.  Redirect stdout to devnull so the
        # interpreter's shutdown flush doesn't re-raise.
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        sys.exit(141)  # 128 + SIGPIPE
    except _USER_ERRORS as e:
        if os.environ.get("YOLODL_DEBUG"):
            raise
        msg = str(e) or repr(e)
        if isinstance(e, KeyError):
            msg = f"missing config key {msg}"
        elif isinstance(e, FileNotFoundError):
            msg = f"file not found: {e.filename or msg}"
        if not write_rank_error(msg):
            print(f"error: {msg}", file=sys.stderr)
        tb = e.__traceback__
        while tb is not None and tb.tb_next is not None:
            tb = tb.tb_next
        if tb is not None:
            frame = tb.tb_frame
            print(f"({type(e).__name__} at "
                  f"{frame.f_code.co_filename}:{tb.tb_lineno}; "
                  "set YOLODL_DEBUG=1 for a full traceback)", file=sys.stderr)
        sys.exit(1)
