"""Rendering: rays and hits, camera, film, emitters, scene, integrator."""
