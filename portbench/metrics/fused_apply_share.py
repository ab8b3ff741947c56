"""fused_apply_share: the share of the sync iteration's attraction launches
that also apply the repulsion and X's update (the program's launch count
``ell_edge_apply``) against those that only sum the attraction
(``ell_edge_force``), over the run, in percent: 100 x fused / (fused +
edge); nothing where the program counts no such launch."""


def read(ctx):
    try:
        from force2vec_tpu_torch.ops.force_kernels import launch_counts
    except ImportError:
        return None
    fused = launch_counts.get("ell_edge_apply")
    if fused is None:
        return None
    total = fused + launch_counts.get("ell_edge_force", 0)
    return 100.0 * fused / total if total else None
