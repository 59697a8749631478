"""Runtime context, parallel layout and 2D-Attention."""
