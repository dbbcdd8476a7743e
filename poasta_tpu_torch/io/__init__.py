from .fasta import read_fasta, read_fastq, poa_graph_to_fasta, is_fasta_path
from .gfa import load_graph_from_gfa, graph_to_gfa, graph_to_gfav1, GraphSegments
from .gaf import alignment_to_gaf, GAFRecord, NodeSegmentResolver
from .graph_io import (
    save_graph,
    load_graph,
    load_graph_from_fasta_msa,
    graph_to_dot,
    format_as_dot,
)

__all__ = [
    "read_fasta",
    "read_fastq",
    "poa_graph_to_fasta",
    "is_fasta_path",
    "load_graph_from_gfa",
    "graph_to_gfa",
    "graph_to_gfav1",
    "GraphSegments",
    "alignment_to_gaf",
    "GAFRecord",
    "NodeSegmentResolver",
    "save_graph",
    "load_graph",
    "load_graph_from_fasta_msa",
    "graph_to_dot",
    "format_as_dot",
]
