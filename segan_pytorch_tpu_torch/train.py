"""Training CLI of the port: the argparse surface of the repo's ``train.py`` (pinned to it
by ``tests/test_torch_config.py``) running the SEGAN+ engine of
``segan_pytorch_tpu_torch/models/segan.py``.

    python -m segan_pytorch_tpu_torch.train --save_path ckpt_segan+ \\
        --clean_trainset data/clean_trainset --noisy_trainset data/noisy_trainset \\
        [--clean_valset ... --noisy_valset ...] --batch_size 300 --no_bias \\
        [--resume] [--device cuda|cpu]

It slices the wav directories (``data/se_dataset.py``), shuffles and batches them
(``data/loader.py``), trains with the decaying L1 weight, logs, writes training samples,
scores the validation set with early stop, and keeps rotating checkpoints that
``--resume`` continues from; SIGTERM checkpoints and exits 0. It runs on the CUDA card,
and raises without one; ``--device cpu`` (or ``--no-cuda``) asks for the CPU. Options
the port does not run yet (WSEGAN, AEWSEGAN, H5 data, noise augmentation, the streaming
shuffle, several steps per call, profiling, a cast in the loader, more than one device
or process, random scaling, pre-emphasis before normalisation) raise
``NotImplementedError`` when set; the TPU lowering knobs are recorded in ``train.opts``
and have no effect.
"""
import argparse
import random

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--save_path', type=str, default="seganv1_ckpt",
                        help="Path to save models (Def: seganv1_ckpt).")
    parser.add_argument('--d_pretrained_ckpt', type=str, default=None,
                        help='Path to ckpt file to pre-load in training (Def: None).')
    parser.add_argument('--g_pretrained_ckpt', type=str, default=None,
                        help='Path to ckpt file to pre-load in training (Def: None).')
    parser.add_argument('--cache_dir', type=str, default='data_cache')
    parser.add_argument('--clean_trainset', type=str, default='data/clean_trainset')
    parser.add_argument('--noisy_trainset', type=str, default='data/noisy_trainset')
    parser.add_argument('--clean_valset', type=str, default=None)
    parser.add_argument('--noisy_valset', type=str, default=None)
    parser.add_argument('--h5_data_root', type=str, default=None,
                        help='H5 data root dir (Def: None).')
    parser.add_argument('--h5', action='store_true', default=False,
                        help='Activate H5 dataset mode (Def: False).')
    parser.add_argument('--data_stride', type=float, default=0.5,
                        help='Stride in seconds for data read')
    parser.add_argument('--seed', type=int, default=111)
    parser.add_argument('--epoch', type=int, default=100)
    parser.add_argument('--patience', type=int, default=100,
                        help='Validation epochs to wait before early stop (Def: 100).')
    parser.add_argument('--batch_size', type=int, default=100)
    parser.add_argument('--save_freq', type=int, default=50,
                        help="Batch save freq (Def: 50).")
    parser.add_argument('--slice_size', type=int, default=16384)
    parser.add_argument('--opt', type=str, default='rmsprop')
    parser.add_argument('--l1_dec_epoch', type=int, default=100)
    parser.add_argument('--l1_weight', type=float, default=100,
                        help='L1 regularization weight (Def. 100).')
    parser.add_argument('--l1_dec_step', type=float, default=1e-5,
                        help='L1 regularization decay factor by batch (Def: 1e-5).')
    parser.add_argument('--g_lr', type=float, default=0.00005)
    parser.add_argument('--d_lr', type=float, default=0.00005)
    parser.add_argument('--preemph', type=float, default=0.95)
    parser.add_argument('--max_samples', type=int, default=None)
    parser.add_argument('--eval_workers', type=int, default=2)
    parser.add_argument('--slice_workers', type=int, default=1)
    parser.add_argument('--num_workers', type=int, default=1)
    parser.add_argument('--no-cuda', dest='no_cuda', action='store_true', default=False,
                        help='Same as --device cpu')
    parser.add_argument('--random_scale', type=float, nargs='+', default=[1])
    parser.add_argument('--no_train_gen', action='store_true', default=False)
    parser.add_argument('--preemph_norm', action='store_true', default=False)
    parser.add_argument('--wsegan', action='store_true', default=False)
    parser.add_argument('--aewsegan', action='store_true', default=False)
    parser.add_argument('--vanilla_gan', action='store_true', default=False)
    parser.add_argument('--no_bias', action='store_true', default=False)
    parser.add_argument('--n_fft', type=int, default=2048)
    parser.add_argument('--reg_loss', type=str, default='l1_loss',
                        help='Regression loss (l1_loss or mse_loss) in G (Def: l1_loss)')
    # Skip connections
    parser.add_argument('--skip_merge', type=str, default='concat')
    parser.add_argument('--skip_type', type=str, default='alpha')
    parser.add_argument('--skip_init', type=str, default='one')
    parser.add_argument('--skip_kwidth', type=int, default=11)
    # Generator
    parser.add_argument('--gkwidth', type=int, default=31)
    parser.add_argument('--genc_fmaps', type=int, nargs='+',
                        default=[64, 128, 256, 512, 1024])
    parser.add_argument('--genc_poolings', type=int, nargs='+', default=[4, 4, 4, 4, 4])
    parser.add_argument('--z_dim', type=int, default=1024)
    parser.add_argument('--gdec_fmaps', type=int, nargs='+', default=None)
    parser.add_argument('--gdec_poolings', type=int, nargs='+', default=None)
    parser.add_argument('--gdec_kwidth', type=int, default=None)
    parser.add_argument('--gnorm_type', type=str, default=None)
    parser.add_argument('--no_z', action='store_true', default=False)
    parser.add_argument('--no_skip', action='store_true', default=False)
    parser.add_argument('--pow_weight', type=float, default=0.001)
    parser.add_argument('--misalign_pair', action='store_true', default=False)
    parser.add_argument('--interf_pair', action='store_true', default=False)
    # Discriminator
    parser.add_argument('--denc_fmaps', type=int, nargs='+',
                        default=[64, 128, 256, 512, 1024])
    parser.add_argument('--dpool_type', type=str, default='none')
    parser.add_argument('--dpool_slen', type=int, default=16)
    parser.add_argument('--dkwidth', type=int, default=None)
    parser.add_argument('--denc_poolings', type=int, nargs='+', default=[4, 4, 4, 4, 4])
    parser.add_argument('--dnorm_type', type=str, default='bnorm')
    parser.add_argument('--phase_shift', type=int, default=5)
    parser.add_argument('--sinc_conv', action='store_true', default=False)
    # extensions of the JAX package
    parser.add_argument('--dp', type=int, default=1,
                        help='Data-parallel shards (Def: 1; more is not ported yet).')
    parser.add_argument('--mp', type=int, default=1,
                        help='Tensor-parallel degree (Def: 1; more is not ported yet).')
    parser.add_argument('--compute_dtype', type=str, default='float32',
                        help='float32 | bfloat16 network compute dtype.')
    parser.add_argument('--use_pallas', action='store_true', default=False,
                        help='TPU knob, recorded in train.opts; no effect in the port.')
    parser.add_argument('--deconv_impl', type=str, default=None,
                        choices=['dilated', 'blocked', 'edge-blocked', 'phased'],
                        help='TPU knob, recorded in train.opts; no effect in the port.')
    parser.add_argument('--profile', action='store_true', default=False,
                        help='Not ported yet.')
    parser.add_argument('--eval_max_samples', type=int, default=1,
                        help='Validation batches scored per epoch '
                             '(1 = reference parity, 0 = full valset sweep).')
    parser.add_argument('--steps_per_call', type=int, default=1,
                        help='Train steps per call (Def: 1; more is not ported yet).')
    parser.add_argument('--io_threads', type=int, default=0,
                        help='Native wav-gather thread-pool size '
                             '(0 = hardware concurrency).')
    parser.add_argument('--shuffle_buffer', type=int, default=0,
                        help='Streaming shuffle buffer (Def: 0; more is not ported yet).')
    parser.add_argument('--shuffle_buffer_mode', type=str, default='sharded',
                        choices=['sharded', 'global'],
                        help='Mode of the streaming shuffle (not ported yet).')
    parser.add_argument('--loader_dtype', type=str, default=None,
                        help='Cast at collate time (not ported yet).')
    parser.add_argument('--noises_dir', type=str, default=None,
                        help='Additive-noise augmentation (not ported yet).')
    parser.add_argument('--snr_levels', type=int, nargs='+', default=[0, 5, 10],
                        help='SNR targets (dB) of --noises_dir (not ported yet).')
    parser.add_argument('--resume', action='store_true', default=False,
                        help='Resume from the latest EOE checkpoints in save_path.')
    parser.add_argument('--eoe_save_every', type=int, default=1,
                        help='Save EOE checkpoints every N epochs (Def: 1).')
    parser.add_argument('--coordinator', type=str, default=None,
                        help='Multi-host coordinator (not ported yet).')
    parser.add_argument('--num_processes', type=int, default=None,
                        help='Total number of training processes (not ported yet).')
    parser.add_argument('--process_id', type=int, default=None,
                        help='This process index (not ported yet).')
    # the port's own
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (the default) needs a card; cpu runs the plain '
                             'PyTorch versions of the kernels')
    return parser


def main(argv=None):
    """Parse `argv` (default: the command line), dump train.opts into --save_path and
    train. Returns the engine."""
    import torch

    from .data.loader import DataLoader
    from .data.se_dataset import SEDataset
    from .models.segan import SEGAN, default_device, unported_options
    from .utils.config import SEGANConfig, dump_train_opts

    opts = vars(build_parser().parse_args(argv))
    device_name = 'cpu' if opts['no_cuda'] else opts['device']
    del opts['device']  # not a config field: train.opts holds what train.py's holds
    cfg = SEGANConfig.from_dict(opts)
    cfg.bias = not cfg.no_bias  # derived flag (ref train.py:248)
    unported = unported_options(cfg)
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")
    device = default_device() if device_name == 'cuda' else torch.device('cpu')
    dump_train_opts(cfg)
    print('Parsed arguments: ', cfg.to_json())

    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    segan = SEGAN(cfg, device=device)
    print('Total model parameters: ', segan.get_n_params())
    if cfg.resume:
        segan.resume(cfg.save_path)
    if cfg.g_pretrained_ckpt is not None:
        segan.g_load_pretrained(cfg.g_pretrained_ckpt)
    if cfg.d_pretrained_ckpt is not None:
        segan.d_load_pretrained(cfg.d_pretrained_ckpt)

    dset = SEDataset(cfg.clean_trainset, cfg.noisy_trainset, cfg.preemph,
                     cache_dir=cfg.cache_dir, split='train',
                     stride=cfg.data_stride, slice_size=cfg.slice_size,
                     max_samples=cfg.max_samples, verbose=True,
                     slice_workers=cfg.slice_workers, io_threads=cfg.io_threads)
    dloader = DataLoader(dset, batch_size=cfg.batch_size, shuffle=True,
                         num_workers=cfg.num_workers, seed=cfg.seed)
    if cfg.clean_valset is not None:
        va_dset = SEDataset(cfg.clean_valset, cfg.noisy_valset, cfg.preemph,
                            cache_dir=cfg.cache_dir, split='valid',
                            stride=cfg.data_stride, slice_size=cfg.slice_size,
                            max_samples=cfg.max_samples, verbose=True,
                            slice_workers=cfg.slice_workers, io_threads=cfg.io_threads)
        va_dloader = DataLoader(va_dset, batch_size=300, shuffle=False,
                                num_workers=cfg.num_workers, seed=cfg.seed)
    else:
        va_dloader = None
    segan.train(cfg, dloader, cfg.l1_weight, cfg.l1_dec_step, cfg.l1_dec_epoch,
                cfg.save_freq, va_dloader=va_dloader)
    return segan


if __name__ == '__main__':
    main()
