"""Keyframe window, bundle adjustment and pose graph: the backend."""
