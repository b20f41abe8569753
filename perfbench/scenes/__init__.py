"""Scene generators, one file each, found by the name a configuration's
"scene" key gives. Each has `arrays(**scene_args) -> (vertices (N, 3, 3)
float32, material ids (N,) int32, material specs as dicts of
MaterialSpec fields)`: the raw inputs that the program's `build_scene`
and the reference's `build_ref_scene` are both handed."""
