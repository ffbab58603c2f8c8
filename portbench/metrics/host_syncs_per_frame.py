"""``host_syncs_per_frame``: the host's reads of one device value
(``aten::_local_scalar_dense``) in the traced replay, per frame."""


def read(run):
    prof = run.profile
    return prof["syncs"] / prof["frames"] if prof else None
