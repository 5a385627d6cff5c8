"""igpm-pem — the paper's own system (Kanezashi et al. 2018). ``FULL`` is the
serving configuration at the published scale, ``SMOKE`` a reduced one;
``SHAPES`` are the four Table III dataset twins (the 'stream' kind drives
the temporal pattern-matching loop). Values match the JAX package's
``repro.configs.igpm_paper``."""

from repro_torch.config.base import ArchConfig, IGPMConfig, ShapeSpec

FULL = IGPMConfig(n_max=262_144, e_max=8_388_608, n_labels=4,
                  rwr_iters=25, rwr_iters_incremental=5, top_k_patterns=20,
                  backend="ell", ell_width=64)

SMOKE = IGPMConfig(n_max=1024, e_max=16_384, n_labels=4, rwr_iters=10,
                   rwr_iters_incremental=3, top_k_patterns=8,
                   backend="ell", ell_width=16)

SHAPES = (
    ShapeSpec("friends2008", "stream",
              {"n_vertices": 224_879, "n_edges": 3_871_909, "steps": 6_893}),
    ShapeSpec("transactions", "stream",
              {"n_vertices": 112_130, "n_edges": 538_597, "steps": 1_779}),
    ShapeSpec("sx-askubuntu", "stream",
              {"n_vertices": 159_316, "n_edges": 964_437, "steps": 2_060}),
    ShapeSpec("sx-mathoverflow", "stream",
              {"n_vertices": 24_818, "n_edges": 506_550, "steps": 2_350}),
)


def full() -> ArchConfig:
    return ArchConfig("igpm-pem", "igpm", FULL, SHAPES,
                      source="Kanezashi et al. 2018")


def smoke() -> ArchConfig:
    return ArchConfig("igpm-pem", "igpm", SMOKE, SHAPES,
                      source="Kanezashi et al. 2018")
