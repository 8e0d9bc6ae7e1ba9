"""``python -m kubeml_tpu_torch.cli <verb> ...``: the kubeml CLI."""

from kubeml_tpu_torch.cli.main import main

if __name__ == "__main__":
    main()
