"""Command-line tools mirroring the reference's five programs.

Each submodule is runnable as ``python -m pulseportraiture_tpu.cli.<tool>``
and exposes ``main(argv=None)``.  Flag names track the reference CLIs
(pptoas.py:1422-1629, ppgauss.py:658-800, ppspline.py:279-383,
ppalign.py:245-380, ppzap.py:98-241) with argparse long options.

Every tool accepts ``--platform {cpu,gpu}``, which pins
``jax_platforms``, and ``--x64``.  Every tool keeps JAX's persistent
compilation cache (utils.use_compile_cache).
"""


def add_common_args(parser):
    parser.add_argument("--platform", default=None,
                        help="force the jax backend (e.g. cpu, gpu)")
    parser.add_argument("--x64", action="store_true",
                        help="enable float64 (CPU parity mode)")
    return parser


def apply_common_args(args):
    import jax

    from pulseportraiture_tpu.utils import use_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    use_compile_cache()
