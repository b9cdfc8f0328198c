"""The port's CLI runs grid and particle mode: options of parts not
ported yet are refused with the ROADMAP item that holds them, before any
work starts, and the mesh and transfer-function flags are not accepted."""

import pytest
import torch

from nfs_tpu_torch.cli.stylize import build_parser, main

torch.set_num_threads(2)


@pytest.mark.parametrize("argv, item", [
    (["--mode", "particle", "--opt_color"], "item 6"),
    (["--parallel"], "item 21"),
    (["--fused", "4"], "item 13"),
    (["--checkpoint_in_frame"], "item 16"),
])
def test_unported_options_raise(argv, item, tmp_path):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        main(argv + ["--device", "cpu", "--log_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("argv", [
    ["--mesh_views", "2"],
    ["--train_transfer"],
    ["--mesh_frames", "2"],
    ["--transfer_fn", "fire"],
])
def test_particle_mesh_and_transfer_flags_absent(argv):
    with pytest.raises(SystemExit):
        build_parser().parse_args(argv)


def test_particle_flags_reach_the_config():
    from nfs_tpu_torch.cli.stylize import config_from_args

    args = build_parser().parse_args(
        ["--mode", "particle", "--no_opt_position", "--opt_density",
         "--keyframe_stride", "4", "--max_log_dens", "2.0",
         "--grid_shape", "8", "9", "10", "--p_path", "q_%04d.npz"])
    cfg = config_from_args(args)
    pc = cfg.particle
    assert (pc.optimize_position, pc.optimize_density, pc.optimize_color,
            pc.keyframe_stride, pc.max_log_dens) == (False, True, False, 4,
                                                     2.0)
    assert cfg.data.p_path == "q_%04d.npz"
    assert args.grid_shape == [8, 9, 10]
