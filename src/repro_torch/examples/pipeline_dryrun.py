"""Pipeline-parallel dry run: chameleon-34b's 48-layer stack as a
16-stage GPipe pipeline on the production (data 16, model 16) mesh, 3
layers a stage and 64 microbatches (bubble fraction 15/79, about 19 %),
the twin of the reference's ``examples/pipeline_dryrun.py``.

  PYTHONPATH=src python -m repro_torch.examples.pipeline_dryrun

Like ``repro_torch.launch.dryrun`` it runs as rank 0 of a fake process
group of 256 ranks, on fake tensors, so it asks for no device and
allocates nothing. The parameters are placed by stage
(``dist.pipeline.stage_params``): rank 0 holds its 3 layers and the
embedding, the final norm and the head whole; the tokens (256 x 4,096)
are whole on every rank, as the reference's are. One forward runs
(``pipeline_lm_forward``, no gradient, as the reference lowers it) and
is counted per device: FLOPs (every one of the 79 schedule steps, where
the reference's cost analysis counts its scanned step once), argument
and temporary bytes, collectives (the ring shift counts as
``collective-permute``).
"""
import argparse
import time

import torch

from repro_torch.configs import ARCHS

ARCH = "chameleon-34b"
B, S, M = 256, 4096, 64


def run(batch: int = B, seq: int = S, n_micro: int = M) -> dict:
    """The dry run's counts for one pipelined forward (see the module's
    note), with ``slab_bytes`` (the rank's own layers), ``other_bytes``
    (the leaves outside the layers) and ``bubble`` ((n-1)/(M+n-1))."""
    from repro_torch.dist import shardings as sh
    from repro_torch.dist.pipeline import pipeline_lm_forward, stage_params
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import lm
    cfg = ARCHS[ARCH]
    t0 = time.perf_counter()
    with D.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        n_stages = sh._mesh_axis_size(mesh, "model")
        with D._fake_mode(), sh.use_mesh(mesh):
            staged = stage_params(
                cfg, lm.init_params(cfg, torch.Generator().manual_seed(0)),
                mesh)
            tokens = torch.zeros((batch, seq), dtype=torch.int32)

            @torch.no_grad()
            def forward(params, tokens):
                return pipeline_lm_forward(cfg, params, tokens, mesh,
                                           n_micro=n_micro)

            out = D.count_step(forward, (staged, tokens))
            slab = sum(D._nbytes(t) for lp in staged.layers
                       for t in lm.leaves(lp))
            other = sum(D._nbytes(t) for t in lm.leaves(staged)) - slab
    out.update({"arch": ARCH, "n_devices": 256, "n_stages": n_stages,
                "layers_a_stage": len(staged.layers), "n_micro": n_micro,
                "slab_bytes": slab, "other_bytes": other,
                "tokens_bytes": D._nbytes(tokens),
                "bubble": (n_stages - 1) / (n_micro + n_stages - 1),
                "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> dict:
    argparse.ArgumentParser(
        prog="python -m repro_torch.examples.pipeline_dryrun",
        description="chameleon-34b as 16 GPipe stages on the fake "
                    "(16, 16) mesh").parse_args(argv)
    res = run()
    gib = 2 ** 30
    print(f"pipeline forward counted on {res['n_devices']} devices "
          f"({res['n_stages']} stages x {res['layers_a_stage']} layers)")
    print(f"  flops/device (every schedule step): "
          f"{res['flops_per_device']:.3e}")
    print(f"  args {res['argument_size_in_bytes'] / gib:.2f} GiB/dev "
          f"(stage slab {res['slab_bytes'] / gib:.2f}, embedding, norm and "
          f"head {res['other_bytes'] / gib:.2f}, tokens "
          f"{res['tokens_bytes'] / gib:.3f}), temps "
          f"{res['temp_size_in_bytes'] / gib:.2f} GiB/dev")
    print(f"  collectives/device: "
          + ", ".join(f"{k} {v:.3e} B" for k, v in
                      res["collectives"]["bytes"].items() if v))
    print(f"  bubble fraction: {res['bubble']:.1%} "
          f"(M={res['n_micro']} microbatches)")
    return res


if __name__ == "__main__":
    main()
