"""Execution-mode state (port of paddle_tpu/static/mode.py). Eager
(dygraph) is the default, as in Paddle 2.0.

enable_static() turns on the capture of static/program.py: from then
on, in this thread, an op or a torch function that meets a static
Variable appends an OpDesc to the current Program instead of running,
and layers built without a device hold their parameters as Variables
(no device memory). disable_static() turns it off.
Left out: nothing.
"""

_static_mode = False


def in_dynamic_mode():
    return not _static_mode


def in_static_mode():
    return _static_mode


def enable_static():
    global _static_mode
    if _static_mode:
        return
    from .program import _start_capture
    _start_capture()
    _static_mode = True


def disable_static():
    global _static_mode
    if not _static_mode:
        return
    from .program import _stop_capture
    _stop_capture()
    _static_mode = False
