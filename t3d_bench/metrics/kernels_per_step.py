"""kernels_per_step (`.train`, `.infer`): device kernels (copies and
sets left out) a step of the traced stretch, rank 0's."""


def read(rd):
    if not rd.stretches:
        return None
    st = rd.stretches[0]
    return len(st.kernels()) / st.steps
