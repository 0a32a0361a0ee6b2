from doa_mpc_tpu_torch.cli import main

main()
