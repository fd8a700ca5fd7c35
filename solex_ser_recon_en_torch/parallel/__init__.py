"""Scale-out across processes: the folder batch's deterministic split."""
