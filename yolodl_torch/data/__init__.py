"""Host-side image preparation (numpy; PIL only where a frame is resized)."""
