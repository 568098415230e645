// fast_nnunet_engine CLI — the reference's example program flow
// (ref engine/fast_nnunet.cpp:12-31: Eva::initializer -> set_config ->
// set_workspace -> LoadData -> infer -> save_mask). The PyTorch port's copy of
// engine/src/main.cpp: --aoti (an AOTInductor package, on the card by
// default) takes the place of --pjrt/--artifact.
#include <chrono>
#include <cstdlib>
#include <cstring>
#include <iostream>
#include <string>

#include "fast_nnunet/engine.h"

namespace {
void usage(const char* prog) {
    std::cerr << "usage: " << prog
              << " --config model.ini --input ct.nii.gz --output mask.nii.gz\n"
              << "        [--endpoint host:port] [--aoti model_aoti.pt2 "
                 "[--device cuda|cpu] [--fp32-input]]\n"
              << "        [--workspace dir] [--verbose]\n"
              << "\nBackends: --aoti runs the exporter's AOTInductor package "
                 "in-process on the\ndevice it was compiled for (cuda by "
                 "default; --fp32-input for a float32\nexport); --endpoint "
                 "posts to the serving daemon; neither runs the null\n"
                 "backend (pipeline test: all-background mask).\n";
}
}  // namespace

int main(int argc, char** argv) {
    std::string config, input, output, endpoint, workspace = ".";
    std::string aoti_package, device = "cuda";
    bool verbose = false, fp32_input = false;
    for (int i = 1; i < argc; ++i) {
        std::string a = argv[i];
        auto next = [&](const char* what) -> std::string {
            if (i + 1 >= argc) {
                std::cerr << what << " requires a value\n";
                exit(2);
            }
            return argv[++i];
        };
        if (a == "--config") config = next("--config");
        else if (a == "--input") input = next("--input");
        else if (a == "--output") output = next("--output");
        else if (a == "--endpoint") endpoint = next("--endpoint");
        else if (a == "--aoti") aoti_package = next("--aoti");
        else if (a == "--device") device = next("--device");
        else if (a == "--fp32-input") fp32_input = true;
        else if (a == "--workspace") workspace = next("--workspace");
        else if (a == "--verbose") verbose = true;
        else if (a == "--help" || a == "-h") { usage(argv[0]); return 0; }
        else { std::cerr << "unknown arg " << a << "\n"; usage(argv[0]); return 2; }
    }
    if (config.empty() || input.empty() || output.empty()) {
        usage(argv[0]);
        return 2;
    }

    try {
        fast_nnunet::FastnnUNet::Engine engine;
        engine.set_config(config);
        engine.set_workspace(workspace, verbose);
        // reference flow parity: the INI's [model] file_name names the
        // compiled model; with an AOTInductor package there, the in-process
        // backend needs no extra flags
        const std::string& model_file = engine.config().file_name;
        if (aoti_package.empty() && model_file.size() > 4 &&
            model_file.compare(model_file.size() - 4, 4, ".pt2") == 0)
            aoti_package = model_file;
        if (!aoti_package.empty()) {
            engine.set_backend(fast_nnunet::make_aoti_backend(
                aoti_package, device, fp32_input ? "float32" : "bfloat16"));
        } else if (!endpoint.empty()) {
            auto colon = endpoint.rfind(':');
            if (colon == std::string::npos)
                throw std::runtime_error("--endpoint must be host:port");
            engine.set_backend(fast_nnunet::make_http_backend(
                endpoint.substr(0, colon),
                std::stoi(endpoint.substr(colon + 1))));
        }

        auto t0 = std::chrono::steady_clock::now();
        fast_nnunet::Volume vol = fast_nnunet::Data::LoadData(input);
        auto t1 = std::chrono::steady_clock::now();
        std::vector<uint8_t> mask = engine.infer(vol, true, false, true);
        auto t2 = std::chrono::steady_clock::now();
        fast_nnunet::Tools::save_mask(mask, vol, output);
        auto t3 = std::chrono::steady_clock::now();

        auto ms = [](auto a, auto b) {
            return std::chrono::duration_cast<std::chrono::milliseconds>(b - a)
                .count();
        };
        std::cout << "load " << ms(t0, t1) << " ms, infer " << ms(t1, t2)
                  << " ms, save " << ms(t2, t3) << " ms -> " << output << "\n";
        return 0;
    } catch (const std::exception& e) {
        std::cerr << "error: " << e.what() << "\n";
        return 1;
    }
}
