from sibeliaz_tpu_torch.cli import main

main()
