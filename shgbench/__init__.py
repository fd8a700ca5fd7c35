"""The benchmark of solex_ser_recon_en_torch on the card: one cell, one run
(``python3 shgbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``)."""
