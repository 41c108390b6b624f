from topotpu_torch.cli.main import main

if __name__ == "__main__":
    raise SystemExit(main())
