"""The staged reconstruction pipeline (the shg -c main path)."""
