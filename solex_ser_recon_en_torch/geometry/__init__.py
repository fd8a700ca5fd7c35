"""Spectral-line fit, limb edges, ellipse fit and warp geometry."""
