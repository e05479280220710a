"""Host-side data: dataset records and loaders, image decode and letterbox
(numpy and PIL; ``letterbox.py`` imports PIL only where a frame is resized)."""
