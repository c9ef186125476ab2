"""Editor core: playback/interaction state machine over Backend + Timeline.

Headless functional equivalent of the reference editor's ``Editor`` struct
(particle_editor/src/editor.rs) minus the egui widget tree. Everything the
GUI surfaced is an API here (the headless CLI and tests drive it; a GUI could
sit on top unchanged):

- **interactive mode** (editor.rs:223-229): playhead at the live edge AND
  auto-play AND not looping AND not editing AND >2 frames. Only then do live
  parameter edits flow to the engine, and only on change (editor.rs:264-270);
- **tick(wall_dt)** = the per-vsync render pass (editor.rs:231-273): drain
  engine frames into the timeline, advance the playhead by wall_dt *
  play_speed (sim seconds per wall second, the log-slider 1e-15..1), send
  metadata-only updates when interactive;
- **actions** mirror the keyboard shortcuts (editor.rs:740-790): space =
  play/pause, arrows = seek, C = clear scene, L = send lattice, D =
  disconnect;
- **cursor interaction** (editor.rs:392-431): while the cursor is "down" its
  normalized position + size ride the metadata; (-1,-1) = no cursor;
- **editing** pauses playback, applies tool strokes to a copy of the current
  frame, and "Edit & Resend" ships it as a scene reset (editor.rs:1087-1095)
  — resume-from-any-frame.

The port's own copy of ``particle_simulator_tpu/editor/core.py``: a scripted
session writes the same wire bytes (``tests/test_torch_editor.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from particle_simulator_tpu_torch.editor.backend import Backend
from particle_simulator_tpu_torch.editor.timeline import Timeline
from particle_simulator_tpu_torch.editor.tools import Stroke, ToolOptions, apply_stroke
from particle_simulator_tpu_torch.io.frame import Frame, PARTICLE_DTYPE, default_metadata
from particle_simulator_tpu_torch.io.presets import ParticleLattice, Preset, Presets

DEFAULT_PLAY_SPEED = 5e-12  # sim seconds per wall second (editor bottom panel)


class Editor:
    def __init__(self, backend: Optional[Backend] = None):
        self.backend = backend or Backend(tcp=False)
        self.timeline = Timeline()
        self.presets = Presets()

        # playback state (editor.rs:108-153)
        self.play_time = 0.0  # playhead, sim seconds
        self.auto_play = True
        self.loop = False
        self.play_speed = DEFAULT_PLAY_SPEED
        self.editing = False

        # live-editable simulation parameters (the Parameters panel)
        self.sim_params = default_metadata()
        self._last_sent_params: Optional[np.ndarray] = None

        # cursor interaction (editor.rs:392-431)
        self.cursor_down = False

        # "clear and send next" (editor.rs:126,1085): the next scene send
        # (lattice or preset) first clears the timeline, then unsets itself
        self.next_send_and_clear = False

        # stats surface (editor.rs:1228-1289)
        self.frames_received = 0
        self.last_scene: Optional[Frame] = None
        self._edit_frame: Optional[Frame] = None
        self._edit_preset_index: Optional[int] = None

    # -- interactive mode (editor.rs:223-229) ---------------------------------
    def at_live_edge(self, slack: float = 1e-18) -> bool:
        return self.play_time >= self.timeline.sim_len() - slack

    def is_interactive(self) -> bool:
        return (
            self.at_live_edge()
            and self.auto_play
            and not self.loop
            and not self.editing
            and self.timeline.frame_count > 2
        )

    # -- the per-frame pass (editor.rs:231-273) ---------------------------------
    def tick(self, wall_dt: float) -> int:
        """Drain engine frames, advance playhead, push live params. Returns the
        number of frames ingested."""
        ingested = 0
        while True:
            frame = self.backend.read()
            if frame is None:
                break
            self.timeline.push_frame(frame)
            self.frames_received += 1
            ingested += 1

        if self.auto_play and not self.editing:
            if self.is_interactive():
                self.play_time = self.timeline.sim_len()  # ride the live edge
            else:
                self.play_time += wall_dt * self.play_speed
                end = self.timeline.sim_len()
                if self.play_time > end:
                    if self.loop and end > 0:
                        self.play_time = 0.0
                    else:
                        self.play_time = end

        if self.is_interactive():
            self._maybe_send_params()
        return ingested

    def _maybe_send_params(self) -> None:
        """Send a metadata-only frame iff the params changed since the last
        send (editor.rs:264-270)."""
        if not self.cursor_down:
            self.sim_params["cursor_pos"] = (-1.0, -1.0)
        if (
            self._last_sent_params is not None
            and self.sim_params.tobytes() == self._last_sent_params.tobytes()
        ):
            return
        frame = Frame.from_metadata(self.sim_params.copy())
        assert frame.particle_count == 0
        self.backend.write(frame)
        self._last_sent_params = self.sim_params.copy()

    # -- cursor (editor.rs:392-421) ---------------------------------------------
    def cursor_move(self, nx: float, ny: float, down: bool) -> None:
        """Normalized [0,1] canvas coordinates; down = button held."""
        self.cursor_down = down
        if down:
            self.sim_params["cursor_pos"] = (nx, ny)

    # -- playback controls (editor.rs:740-790, 1610-1744) -------------------------
    def toggle_play(self) -> None:
        self.auto_play = not self.auto_play

    def toggle_loop(self) -> None:
        """The playback panel's loop button (editor.rs:1610-1744,
        icons/media-playlist-repeat.png): while looping, playback wraps to
        the timeline start instead of riding the live edge — and interactive
        mode disengages (is_interactive requires not loop, editor.rs:223-229),
        so live param edits stop flowing to the engine."""
        self.loop = not self.loop

    def seek(self, t: float) -> None:
        self.play_time = max(0.0, min(t, self.timeline.sim_len()))

    def seek_live(self) -> None:
        """Jump the playhead to the live edge (the timeline's ▶▶ button) —
        interactive mode engages on the next tick if playing."""
        self.play_time = self.timeline.sim_len()

    def seek_frames(self, delta_frames: int) -> None:
        got = self.timeline.frame(self.play_time)
        if got is None:
            return
        frame, exact = got
        dt = frame.metadata.frame_dt()
        self.seek(exact + delta_frames * dt)

    def current_frame(self) -> Optional[Frame]:
        got = self.timeline.frame(self.play_time)
        return got[0] if got else None

    def display_frame(self) -> tuple[Optional[Frame], float]:
        """(frame to draw, its sim time): the in-progress edit while editing
        (the reference previews the edited copy, editor.rs:481-738), otherwise
        the timeline frame at the playhead."""
        if self.editing and self._edit_frame is not None:
            return self._edit_frame, self.play_time
        got = self.timeline.frame(self.play_time)
        return (got[0], got[1]) if got else (None, 0.0)

    # -- scene actions (editor.rs:740-790, 928-942) ------------------------------
    def send_scene(self, frame: Frame) -> None:
        """Ship a full scene reset and snap the playhead to live."""
        self.backend.write(frame)
        self._last_sent_params = None
        self.last_scene = frame.copy()  # for re-send on engine (re)connect

    def send_lattice(self, nx: int = 50, ny: int = 50, distance_factor: float = 1.1,
                     velocity=(0.0, 0.0), hex_grid: bool = True, ty: int = 0,
                     rng: Optional[np.random.Generator] = None) -> Frame:
        """The L shortcut / "Hexagonal Square" button: a lattice centered in
        the box under the current params (editor.rs:928-942; the default
        interactive scene is 50x50, editor.rs:178-182). ``velocity`` is the
        (min, max) magnitude range and ``ty`` the species — the reference's
        lattice sub-panel knobs (editor.rs:878-925)."""
        frame = Frame.from_metadata(self.sim_params.copy())
        meta = frame.metadata
        lat = ParticleLattice((nx, ny), distance_factor=distance_factor, velocity=velocity)
        center = (meta.box_width / 2, meta.box_height / 2)
        if hex_grid:
            lat.hex_square(frame, center, ty=ty, rng=rng)
        else:
            lat.square(frame, center, ty=ty, rng=rng)
        self._consume_send_and_clear()
        self.send_scene(frame)
        return frame

    def _consume_send_and_clear(self) -> None:
        """Apply the one-shot "clear and send next" flag before a scene send
        (editor.rs:937-939,975-977): wipe the timeline so the new scene
        starts a fresh history."""
        if self.next_send_and_clear:
            self.timeline.clear()
            self.play_time = 0.0
            self.next_send_and_clear = False

    def clear_timeline(self) -> None:
        """The "Clear Timeline" button (editor.rs:1299-1301): free the stored
        frame history (the RAM gauge drops to zero) without touching the
        running scene — the engine keeps streaming and history re-accumulates
        from now."""
        self.timeline.clear()
        self.play_time = 0.0

    def clear_scene(self) -> None:
        """Empty-scene send (an extension; the reference's C shortcut clears
        the TIMELINE, editor.rs:770-772 — that's ``clear_timeline``). A frame
        with particle_count == 0 would be a metadata-only update, not a reset
        — so an all-clear ships one tombstone particle, which the engine's
        scene prep compacts away to an empty scene."""
        frame = Frame.from_metadata(self.sim_params.copy())
        tomb = np.zeros(1, dtype=PARTICLE_DTYPE)
        tomb["ty"] = -1
        frame.extend(tomb)
        self.send_scene(frame)

    def disconnect(self) -> None:
        self.backend.close_connection()

    # -- editing (editor.rs:481-738, 1087-1095) -----------------------------------
    def begin_editing(self) -> Optional[Frame]:
        """Pause on the current frame and return an editable copy."""
        current = self.current_frame()
        if current is None:
            frame = Frame.from_metadata(self.sim_params.copy())
        else:
            frame = current.copy()
        self.editing = True
        self._edit_frame = frame
        self._edit_preset_index = None  # a fresh plain edit, not a preset edit
        return frame

    def begin_editing_empty(self) -> Frame:
        """"New preset from: empty frame" (editor.rs:1014-1030): open an
        empty scene (current params, zero particles) in editing mode."""
        frame = Frame.from_metadata(self.sim_params.copy())
        self.editing = True
        self._edit_frame = frame
        self._edit_preset_index = None
        return frame

    def apply_tool(self, stroke: Stroke, options: ToolOptions,
                   rng: Optional[np.random.Generator] = None) -> int:
        if not self.editing:
            self.begin_editing()
        return apply_stroke(self._edit_frame, stroke, options, rng=rng)

    def resend_current(self) -> None:
        """"Edit & Resend current": ship the edited frame as a scene reset —
        resume-from-any-frame (editor.rs:1087-1095)."""
        if self.editing and self._edit_frame is not None:
            if self._edit_frame.particle_count == 0:
                tomb = np.zeros(1, dtype=PARTICLE_DTYPE)
                tomb["ty"] = -1
                self._edit_frame.extend(tomb)
            self.send_scene(self._edit_frame)
        self.editing = False
        self._edit_frame = None
        self._edit_preset_index = None

    def cancel_editing(self) -> None:
        self.editing = False
        self._edit_frame = None
        self._edit_preset_index = None

    # -- presets (editor.rs:961-1083) ----------------------------------------------
    def save_preset(self, name: str) -> None:
        """Snapshot the visible frame as a new preset — while editing, that is
        the edit frame (the reference's "Save Frame" with edit_preset == -1,
        editor.rs:1060-1066), otherwise the timeline frame at the playhead."""
        frame = self._edit_frame if self.editing else self.current_frame()
        if frame is not None:
            # from_frame copies species + particles itself — no frame.copy()
            self.presets.add(Preset.from_frame(name, frame))

    def send_preset(self, i: int) -> None:
        self._consume_send_and_clear()
        self.send_scene(self.presets[i].to_frame())

    def duplicate_preset(self, i: int) -> None:
        """The preset list's duplicate button (editor.rs:996-1001): a deep
        copy named "Copy of <name>", appended to the list."""
        p = self.presets[i]
        self.presets.add(Preset(
            name=f"Copy of {p.name}",
            box_size=p.box_size,
            species=p.species.copy(),
            particles=p.particles.copy(),
        ))

    def rename_preset(self, i: int, name: str) -> None:
        self.presets[i].name = name

    def delete_preset(self, i: int) -> None:
        """Delete a preset, keeping an in-progress preset edit coherent: an
        open edit of the deleted preset becomes a plain edit (update_preset
        no-ops; save via save_preset/resend_current), and an edit of a
        later preset follows its slot down — otherwise update_preset would
        write the edit back through a stale index onto an unrelated preset."""
        self.presets.delete(i)
        if self._edit_preset_index is not None:
            if self._edit_preset_index == i:
                self._edit_preset_index = None
            elif self._edit_preset_index > i:
                self._edit_preset_index -= 1

    def edit_preset(self, i: int) -> Frame:
        """The preset list's edit button: open the preset's scene in editing
        mode (tools apply to it); ``update_preset`` writes it back to the
        same slot, ``resend_current`` ships it, ``cancel_editing`` discards."""
        self.editing = True
        self._edit_frame = self.presets[i].to_frame()
        self._edit_preset_index = i
        return self._edit_frame

    def update_preset(self, name: str | None = None) -> None:
        """The edit panel's "Save Frame" for a preset edit (editor.rs:
        1053-1081): write the in-progress edit back to the slot it came from
        and leave editing mode. No-op unless editing began via edit_preset
        (a plain begin_editing edit saves via save_preset / resend_current)."""
        i = self._edit_preset_index
        if i is None or not self.editing or self._edit_frame is None:
            return
        if i < len(self.presets):
            new_name = name if name is not None else self.presets[i].name
            self.presets.replace(Preset.from_frame(new_name, self._edit_frame), i)
        self.editing = False
        self._edit_frame = None
        self._edit_preset_index = None

    # -- stats (editor.rs:1228-1289) -------------------------------------------------
    def stats(self) -> dict:
        located = self.timeline.at(self.play_time)  # one locate serves all three
        frame, frame_time, idx = located if located else (None, None, None)
        return {
            "time": self.play_time,
            "frame_time": frame_time,  # "Frame Time x / len"
            "sim_len": self.timeline.sim_len(),
            "step_dt": float(self.sim_params["step_dt"]),
            "frame_index": idx,
            "frame_count": self.timeline.frame_count,
            "particle_count": frame.particle_count if frame else 0,
            "data_structure": frame.metadata.data_structure.display_name if frame else None,
            "device": frame.metadata.device.display_name if frame else None,
            "timeline_ram": self.timeline.timeline_ram,
            "interactive": self.is_interactive(),
            "connection": self.backend.connection_details,
            # independent half-connection states (backend.rs:126-158)
            "reader_connected": self.backend.reader_connected(),
            "writer_connected": self.backend.writer_connected(),
            "tcp_server": self.backend.tcp_server_status(),
        }
