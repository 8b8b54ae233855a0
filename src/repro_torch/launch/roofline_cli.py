"""``python -m repro_torch.launch.roofline_cli --arch A --shape S`` — the
roofline of one cell (``launch.roofline.main``)."""

if __name__ == "__main__":
    from repro_torch.launch.roofline import main

    main()
