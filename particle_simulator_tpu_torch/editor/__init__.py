"""Editor subsystem (headless): the functional surface of the reference's
particle_editor GUI — backend transport with loopback, frame timeline with
time-indexed scrubbing, drawing tools, presets, velocity-colored rendering —
driveable from the CLI (editor.headless), the browser (editor.webview) and
tests. The port's own copy of ``particle_simulator_tpu/editor``: numpy and
the standard library on the port's wire codec, no torch; the tests hold it
byte for byte against the JAX package's."""

from particle_simulator_tpu_torch.editor.backend import Backend
from particle_simulator_tpu_torch.editor.core import Editor
from particle_simulator_tpu_torch.editor.timeline import TimeInterval, Timeline
from particle_simulator_tpu_torch.editor.tools import (
    LatticeKind,
    Stroke,
    Tool,
    ToolOptions,
    apply_stroke,
)

__all__ = [
    "Backend",
    "Editor",
    "TimeInterval",
    "Timeline",
    "LatticeKind",
    "Stroke",
    "Tool",
    "ToolOptions",
    "apply_stroke",
]
