"""Image I/O without Pillow: baseline JPEG and Pillow's bilinear resize."""
