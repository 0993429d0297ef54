"""Mix methods and the classical inpainter."""
