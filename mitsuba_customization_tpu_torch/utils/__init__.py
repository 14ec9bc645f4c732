"""Host-side (numpy) helpers: procedural meshes."""
