"""Offline visualization tools for debug dumps.

Our own implementations of the capabilities of the reference's contrib
scripts (``contrib/poasta_tools/poasta_plot.py`` and
``poasta_graphviz_region.py``): DP-matrix heatmaps from the debug TSV
dumps, and sequence-region subgraph extraction from the annotated DOT
output.  They consume the same file formats the reference's tools do
(node labels ``'X' (ix)``, TSV schema ``node_id/offset/matrix/score``,
``# seq:`` DOT header), so dumps from either implementation work with
either toolset.
"""
