"""CLI flag surface (port of ``v2e2v_tpu/utils/configs.py``).

The reference's flat argparse namespace shared by its CLIs, with the same
flags, defaults and destinations as the JAX package's ``set_configs``, its
additions included, so one command line drives either package's CLIs. The
port's CLIs raise on the flags they do not cover yet, naming the ROADMAP.md
item that brings them.
"""

from __future__ import annotations

import argparse


def set_configs(parser: argparse.ArgumentParser) -> None:
    # ---------------- basic info ----------------
    parser.add_argument("--image_dim", nargs=2, default=[180, 240], type=int,
                        help="Input frame size as height width")
    parser.add_argument("--path_to_model", default="models", type=str,
                        help="Directory for saving checkpoints")
    parser.add_argument("--path_to_test_model", type=str,
                        help="Full path of the checkpoint used for inference")
    parser.add_argument("--model_name", default="", type=str,
                        help="Leading part of the saved model name")

    # ---------------- E2V network ----------------
    parser.add_argument("--model_mode", default="cista-lstc", type=str,
                        help="Reconstruction net: cista-lstc or cista-tc")
    parser.add_argument("-b", "--num_bins", default=5, type=int,
                        help="Temporal bins in the event voxel grid")
    parser.add_argument("-d", "--depth", default=5, type=int,
                        help="Number of unrolled ISTA iterations")
    parser.add_argument("-c", "--base_channels", default=64, type=int,
                        help="Base channel count of the reconstruction net")

    # ---------------- V2E emulator ----------------
    parser.add_argument("--num_pack_frames", default=10, type=int,
                        help="HFR frames per pack (one reconstruction each)")
    parser.add_argument("--event_mode", default="voxel_grid", type=str,
                        help="Emulator output: raw or voxel_grid")
    parser.add_argument("--refractory_period_s", default=0.001, type=float,
                        help="Pixel refractory period in seconds")
    parser.add_argument("--C", default=0.6, type=float,
                        help="Nominal contrast threshold (both polarities)")
    parser.add_argument("--threshold_sigma", default=0.03, type=float,
                        help="Stddev of the per-pixel contrast threshold")
    parser.add_argument("--cutoff_hz", default=0, type=float,
                        help="Photoreceptor lowpass cutoff in Hz (0 = off)")
    parser.add_argument("--ps", default=1, type=float,
                        help="Threshold coefficient for the sparse pixel lattice (Cs = ps*C)")
    parser.add_argument("--pl", default=1, type=float,
                        help="Threshold coefficient for the remaining pixels (Cl = pl*C)")
    parser.add_argument("--qs", default=1, type=float,
                        help="Cutoff coefficient for the sparse pixel lattice (fc_s = qs*fc)")
    parser.add_argument("--ql", default=1, type=float,
                        help="Cutoff coefficient for the remaining pixels (fc_l = ql*fc)")

    # ---------------- training ----------------
    parser.add_argument("--path_to_e2v", type=str,
                        help="Pretrained E2V checkpoint used to warm-start V2E2V training")
    parser.add_argument("--path_to_train_data", type=str,
                        help="Training dataset root")
    parser.add_argument("-s", "--len_sequence", default=10, type=int,
                        help="Reconstructions per loss computation (BPTT window)")
    parser.add_argument("--no_shuffle", dest="shuffle", action="store_false",
                        help="Disable data shuffling")
    parser.set_defaults(shuffle=True)
    parser.add_argument("--epochs", default=1, type=int)
    parser.add_argument("--lr", default=0.0001, type=float, help="Learning rate")
    parser.add_argument("--batch_size", default=1, type=int,
                        help="Batch size (must be 1 with variable-length sequences)")
    parser.add_argument("--is_SummaryWriter", dest="is_SummaryWriter",
                        action="store_true",
                        help="Log training scalars for TensorBoard")
    parser.set_defaults(is_SummaryWriter=False)
    parser.add_argument("--load_epoch_for_train", default=0, type=int,
                        help="Epoch to resume training from")
    parser.add_argument("--load_lr", default=0.0001, type=float,
                        help="Learning rate when resuming")
    parser.add_argument("--add_noise", dest="add_noise", action="store_true",
                        help="Add gaussian noise to training voxel grids")
    parser.set_defaults(add_noise=False)

    # ---------------- testing ----------------
    parser.add_argument("--path_to_test_data", type=str,
                        help="Test dataset root")
    parser.add_argument("--reader_type", default="image_reader", type=str,
                        help="Data loader: upsampling / image_reader / video")
    parser.add_argument("--test_data_name", default=None, type=str,
                        help="Single sequence folder to test (default: all)")
    parser.add_argument("--time_unit", default="s", type=str,
                        help="Unit of timestamps.txt entries: s/ns/ms")
    parser.add_argument("--test_img_num", default=50, type=int,
                        help="Max frames to load per test sequence")
    parser.add_argument("--num_events", default=15000, type=int,
                        help="Event budget per reconstruction")
    parser.add_argument("--test_data_mode", default="real", type=str,
                        help="Test data type: real or upsampled")
    parser.add_argument("--pred_norm", default="minmax", type=str,
                        help="Prediction normalization at eval: minmax (the "
                             "reference's HQF variant) or percentile (its "
                             "commented ECD variant)")

    # ---------------- output ----------------
    parser.add_argument("-o", "--output_folder", default="test_images", type=str,
                        help="Directory for inference outputs")
    parser.add_argument("--no_write_image", dest="is_write_image",
                        action="store_false",
                        help="Do not save reconstructed images")
    parser.set_defaults(is_write_image=True)
    parser.add_argument("--is_write_event", dest="is_write_event",
                        action="store_true", help="Save event preview images")
    parser.set_defaults(is_write_event=False)
    parser.add_argument("--is_write_emap", dest="is_write_emap",
                        action="store_true",
                        help="Save error maps vs ground truth")
    parser.set_defaults(is_write_emap=False)

    # ---------------- display ----------------
    parser.add_argument("--display_train", dest="display_train", action="store_true")
    parser.set_defaults(display_train=False)
    parser.add_argument("--display_test", dest="display_test", action="store_true")
    parser.set_defaults(display_test=False)
    parser.add_argument("--show_events", dest="show_events", action="store_true")
    parser.set_defaults(show_events=True)
    parser.add_argument("--event_display_mode", default="grayscale", type=str)
    parser.add_argument("--num_bins_to_show", default=-1, type=int)

    # ---------------- additions to the reference's flags ----------------
    extra = parser.add_argument_group("additions", "Additions to the reference's flags")
    extra.add_argument("--precision", default="float32", type=str,
                       help="Compute dtype: float32 or bfloat16")
    extra.add_argument("--mesh_data", default=0, type=int,
                       help="Devices on the data-parallel mesh axis (0 = all)")
    extra.add_argument("--mesh_spatial", default=1, type=int,
                       help="Devices on the spatial mesh axis")
    extra.add_argument("--seed", default=0, type=int, help="PRNG seed")
    extra.add_argument("--rng_impl", default="rbg", type=str,
                       choices=["threefry2x32", "rbg", "unsafe_rbg"],
                       help="JAX PRNG implementation for the emulator's noise "
                            "(JAX package only)")
    extra.add_argument("--quant", default="none", type=str,
                       choices=["none", "int8", "int8-static"],
                       help="Post-training int8 quantization of the CISTA core for "
                            "inference: dynamic ('int8') or calibrated static "
                            "('int8-static') activation scales")
    extra.add_argument("--profile_dir", default=None, type=str,
                       help="If set, write a profiler trace here")
    extra.add_argument("--debug_nans", dest="debug_nans", action="store_true",
                       help="Abort on the first NaN")
    extra.add_argument("--drop_seq_tails", dest="drop_seq_tails",
                       action="store_true",
                       help="Drop variable-length sequence tails from training "
                       "data so every batch has the same [T, B] shape")
    extra.add_argument("--num_workers", dest="num_workers", default=0, type=int,
                       help="Worker processes for training-sample loading "
                       "(0 = load in the main process)")
    extra.add_argument("--device_data", dest="device_data",
                       choices=["off", "f32", "bf16"], default="off",
                       help="Upload the whole (uniform-shape) training set to "
                       "device memory once and gather batches on the device "
                       "by index; requires --drop_seq_tails")
    extra.add_argument("--dist_coordinator", default=None, type=str,
                       help="host:port of the coordination service of a "
                       "multi-process run (with --dist_num_processes and "
                       "--dist_process_id). Unset = single-process. Env "
                       "equivalents: V2E2V_COORDINATOR/V2E2V_NUM_PROCESSES/"
                       "V2E2V_PROCESS_ID, or V2E2V_DIST_AUTO=1")
    extra.add_argument("--dist_num_processes", default=None, type=int)
    extra.add_argument("--dist_process_id", default=None, type=int)
    extra.add_argument("--v2e_max_iters", default=32, type=int,
                       help="Static bound on per-pixel events per frame pair "
                       "in the emulator (the reference's loop is unbounded)")
    extra.add_argument("--v2e_iters_impl", default="auto", type=str,
                       choices=["xla", "pallas", "auto"],
                       help="Emulator iteration-loop backend of the JAX package")
    extra.add_argument("--cache_samples", dest="cache_samples",
                       action="store_true",
                       help="Cache decoded/voxelised training samples in RAM "
                       "across epochs")
    extra.set_defaults(debug_nans=False, drop_seq_tails=False,
                       cache_samples=False)
