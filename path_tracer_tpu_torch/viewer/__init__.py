"""Interactive viewer: the progressive preview, camera controls, picking,
the ray probe and the HTTP app."""
