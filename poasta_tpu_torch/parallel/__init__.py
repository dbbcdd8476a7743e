from .mapper import BatchMapper, make_mesh, make_sharded_score_fn, parse_mesh_spec

__all__ = ["BatchMapper", "make_mesh", "make_sharded_score_fn",
           "parse_mesh_spec"]
