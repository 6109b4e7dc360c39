import sys

from jpeg_detection_resnet_ssd_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
