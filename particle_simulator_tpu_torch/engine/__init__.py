"""Engine: state, simulator and the editor-protocol daemon."""
