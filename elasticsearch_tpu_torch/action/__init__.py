"""Distributed action layer (ref: server/.../action/)."""
