"""The port's CLI is grid mode only: options of parts not ported yet are
refused with the ROADMAP item that holds them, before any work starts,
and the particle, mesh and transfer-function flags are not accepted."""

import pytest
import torch

from nfs_tpu_torch.cli.stylize import build_parser, main

torch.set_num_threads(2)


@pytest.mark.parametrize("argv, item", [
    (["--mode", "particle"], "item 19"),
    (["--parallel"], "item 21"),
    (["--fused", "4"], "item 13"),
    (["--checkpoint_in_frame"], "item 16"),
])
def test_unported_options_raise(argv, item, tmp_path):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        main(argv + ["--device", "cpu", "--log_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("argv", [
    ["--grid_shape", "8", "8"],
    ["--opt_density"],
    ["--mesh_frames", "2"],
    ["--transfer_fn", "fire"],
])
def test_particle_mesh_and_transfer_flags_absent(argv):
    with pytest.raises(SystemExit):
        build_parser().parse_args(argv)
